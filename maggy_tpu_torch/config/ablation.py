"""Ablation-study experiment config (reference config/ablation.py:28-67, minus the
Spark-only guard): the port's copy of :mod:`maggy_tpu.config.ablation`, plus
the port's ``device``, as ``HyperparameterOptConfig`` has it: ``None`` leases
CUDA cards (and ``lagom`` raises without CUDA), ``"cpu"`` leases the CPU."""

from __future__ import annotations

from typing import Any, Optional, Union

from maggy_tpu_torch.config.base import LagomConfig


class AblationConfig(LagomConfig):
    def __init__(
        self,
        ablation_study: Any,
        ablator: Union[str, Any] = "loco",
        direction: str = "max",
        name: str = "ablationStudy",
        description: str = "",
        hb_interval: float = 1.0,
        model: Any = None,
        dataset: Any = None,
        num_executors: Optional[int] = None,
        devices_per_trial: int = 1,
        optimization_key: str = "metric",
        log_dir: Optional[str] = None,
        sharding: Optional[Any] = None,
        driver_addr: Optional[str] = None,
        worker_timeout: float = 600.0,
        trial_retries: int = 2,
        retry_backoff: float = 0.5,
        quarantine_after: int = 3,
        quarantine_cooldown: float = 300.0,
        device: Optional[str] = None,
    ):
        super().__init__(name, description, hb_interval)
        if direction not in ("max", "min"):
            raise ValueError(f"direction must be 'max' or 'min', got {direction!r}")
        self.ablation_study = ablation_study
        self.ablator = ablator
        self.direction = direction
        self.model = model
        self.dataset = dataset
        self.num_executors = num_executors
        self.devices_per_trial = int(devices_per_trial)
        self.optimization_key = optimization_key
        self.log_dir = log_dir
        self.sharding = sharding
        self.driver_addr = driver_addr
        self.worker_timeout = float(worker_timeout)
        # trial-loss retry/quarantine policy, forwarded to the HPO scheduling
        # machinery the ablation driver reuses (see HyperparameterOptConfig)
        self.trial_retries = int(trial_retries)
        self.retry_backoff = float(retry_backoff)
        self.quarantine_after = int(quarantine_after)
        self.quarantine_cooldown = float(quarantine_cooldown)
        self.device = device
