"""Experiment configs: the port's copy of :mod:`maggy_tpu.config` (the
tuning config, ROADMAP queue 1 item 9, is not ported)."""

from maggy_tpu_torch.config.ablation import AblationConfig
from maggy_tpu_torch.config.base import BaseConfig, LagomConfig
from maggy_tpu_torch.config.distributed import DistributedConfig
from maggy_tpu_torch.config.hpo import HyperparameterOptConfig

# the JAX package's alias: one config for the one data plane
TpuDistributedConfig = DistributedConfig

__all__ = [
    "LagomConfig",
    "BaseConfig",
    "HyperparameterOptConfig",
    "AblationConfig",
    "DistributedConfig",
    "TpuDistributedConfig",
]
