"""Experiment configs: what the port runs so far. ``AblationConfig`` (ROADMAP
queue 1 item 5b) and ``DistributedConfig`` (item 7) are not ported; the
port's ``lagom`` refuses them by name."""

from maggy_tpu_torch.config.base import BaseConfig, LagomConfig
from maggy_tpu_torch.config.hpo import HyperparameterOptConfig

__all__ = ["LagomConfig", "BaseConfig", "HyperparameterOptConfig"]
