"""Experiment configuration base classes: the port's copy of
:mod:`maggy_tpu.config.base`.

Capability parity with the reference config system (``maggy/config/lagom.py:22-35``,
``base_config.py:23-38``): plain Python config objects whose concrete type selects
the experiment driver via singledispatch. Unlike the reference, none of these carry
a "Spark-only" guard. The port adds ``device``, as ``Trainer`` and ``Engine``
take it: ``None`` leases CUDA cards (and ``lagom`` raises without CUDA),
``"cpu"`` leases the CPU.
"""

from __future__ import annotations

from typing import Any, Optional


class LagomConfig:
    """Base class for all experiment configs (reference config/lagom.py:22-35)."""

    def __init__(self, name: str, description: str = "", hb_interval: float = 1.0):
        if hb_interval <= 0:
            raise ValueError("hb_interval must be positive")
        self.name = name
        self.description = description
        self.hb_interval = float(hb_interval)


class BaseConfig(LagomConfig):
    """Run a train_fn once, unmodified, under experiment bookkeeping
    (reference config/base_config.py:23-38)."""

    def __init__(
        self,
        name: str = "base",
        description: str = "",
        hb_interval: float = 1.0,
        model: Any = None,
        dataset: Any = None,
        hparams: Optional[dict] = None,
        log_dir: Optional[str] = None,
        device: Optional[str] = None,
    ):
        super().__init__(name, description, hb_interval)
        self.model = model
        self.dataset = dataset
        self.hparams = dict(hparams or {})
        self.log_dir = log_dir
        self.device = device
