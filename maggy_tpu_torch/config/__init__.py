"""Experiment configs: what the port runs so far. ``DistributedConfig``
(ROADMAP queue 1 item 7) is not ported; the port's ``lagom`` refuses it by
name."""

from maggy_tpu_torch.config.ablation import AblationConfig
from maggy_tpu_torch.config.base import BaseConfig, LagomConfig
from maggy_tpu_torch.config.hpo import HyperparameterOptConfig

__all__ = ["LagomConfig", "BaseConfig", "HyperparameterOptConfig", "AblationConfig"]
