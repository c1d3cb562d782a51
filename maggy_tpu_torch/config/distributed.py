"""Distributed-training experiment config: the port's copy of
:mod:`maggy_tpu.config.distributed`, plus the port's ``device``.

The config declares a sharding layout (a
:class:`~maggy_tpu_torch.parallel.spec.ShardingSpec` or a preset name) and
``lagom`` runs one process per CUDA card, each an NCCL rank on a mesh of
that layout (``device="cpu"``: gloo ranks on the CPU). ``zero_lvl`` maps
onto the layouts as in JAX: 0 → dp, 2 or 3 → fsdp, 1 → dp with
``zero_stage=1`` (ZeRO-1 over ``data``); ``zero_stage`` and ``bucket_mb``
are stamped onto the resolved spec, whose trainer they configure
(:meth:`~maggy_tpu_torch.train.TrainContext.trainer`). The pod, elastic,
restart and evaluator options and ``data_plane="local"`` and
``min_slices > 1`` raise, naming ROADMAP queue 1 item 7f.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Union

from maggy_tpu_torch.config.base import LagomConfig
from maggy_tpu_torch.parallel.spec import ShardingSpec


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is ROADMAP queue 1 item {item}, not ported yet")


class DistributedConfig(LagomConfig):
    def __init__(
        self,
        module: Any = None,
        dataset: Any = None,
        hparams: Optional[dict] = None,
        sharding: Union[str, ShardingSpec] = "fsdp",
        mixed_precision: bool = True,
        remat: bool = False,
        zero_lvl: Optional[int] = None,
        zero_stage: Optional[int] = None,
        bucket_mb: Optional[float] = None,
        model: Any = None,
        process_data: Optional[Callable] = None,
        name: str = "torchDist",
        hb_interval: float = 1.0,
        description: str = "",
        num_executors: Optional[int] = None,
        seed: int = 0,
        log_dir: Optional[str] = None,
        driver_addr: Optional[str] = None,
        data_plane: str = "auto",
        worker_timeout: float = 1800.0,
        coordinator_port: Optional[int] = None,
        evaluator: bool = False,
        max_restarts: int = 0,
        elastic: bool = False,
        min_slices: int = 1,
        num_slices: Optional[int] = None,
        device: Optional[str] = None,
    ):
        """The JAX config's arguments, with these meanings here:

        :param module: a ``Decoder`` (or any module), or a zero-argument
            factory; handed to the ``train_fn`` as ``module``/``model``.
            With ``mixed_precision``/``remat`` a module with a ``cfg``
            dataclass is rebuilt on the meta device with ``dtype``
            bfloat16/float32 and ``remat`` set.
        :param sharding: a ShardingSpec or a preset ("dp", "fsdp", "tp",
            "2d", ...), resolved against the number of ranks.
        :param num_executors: ranks, one process per card (default: every
            visible card; 1 with ``device="cpu"``).
        :param worker_timeout: seconds a rank may run before the driver
            kills it and fails the run.
        :param coordinator_port: the rendezvous port (``MASTER_PORT``);
            default a free port.
        :param device: None for CUDA cards (``lagom`` raises without CUDA),
            ``"cpu"`` for gloo ranks on the CPU.
        """
        super().__init__(name, description, hb_interval)
        module = module if module is not None else model
        self.module = module
        self.model = module
        self.dataset = dataset
        self.hparams = dict(hparams or {})
        if zero_lvl is not None:
            if zero_lvl not in (0, 1, 2, 3):
                raise ValueError("zero_lvl must be in 0..3")
            sharding = "dp" if zero_lvl in (0, 1) else "fsdp"
            if zero_lvl == 1 and zero_stage is None:
                zero_stage = 1
        if zero_stage is not None and zero_stage not in (0, 1):
            raise ValueError("zero_stage must be 0 or 1")
        if bucket_mb is not None and not float(bucket_mb) > 0:
            raise ValueError("bucket_mb must be positive (or None)")
        self.zero_stage = zero_stage
        self.bucket_mb = bucket_mb
        self.sharding = sharding
        self.mixed_precision = bool(mixed_precision)
        self.remat = bool(remat)
        self.process_data = process_data
        if num_executors is None and os.environ.get("MAGGY_TPU_NUM_EXECUTORS"):
            num_executors = int(os.environ["MAGGY_TPU_NUM_EXECUTORS"])
        self.num_executors = num_executors
        self.seed = int(seed)
        self.log_dir = log_dir
        if driver_addr is not None:
            _refuse("pod mode (driver_addr)", "7f")
        self.driver_addr = driver_addr
        if data_plane not in ("auto", "local"):
            raise ValueError("data_plane must be 'auto' or 'local'")
        if data_plane == "local":
            _refuse("host-local meshes of independent replicas (data_plane='local')", "7f")
        self.data_plane = "auto"
        self.worker_timeout = float(worker_timeout)
        if coordinator_port is None and os.environ.get("MAGGY_TPU_COORDINATOR_PORT"):
            coordinator_port = int(os.environ["MAGGY_TPU_COORDINATOR_PORT"])
        self.coordinator_port = coordinator_port
        if evaluator:
            _refuse("the evaluator worker (evaluator=True)", "7f")
        self.evaluator = False
        if max_restarts == 0 and os.environ.get("MAGGY_TPU_MAX_RESTARTS"):
            max_restarts = int(os.environ["MAGGY_TPU_MAX_RESTARTS"])
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if max_restarts > 0:
            _refuse(f"elastic restarts (max_restarts={max_restarts})", "7f")
        self.max_restarts = 0
        if elastic:
            _refuse("elastic membership (elastic=True)", "7f")
        self.elastic = False
        if min_slices < 1:
            raise ValueError("min_slices must be >= 1")
        if min_slices > 1:
            _refuse(f"elastic shrinking of the mesh (min_slices={min_slices})", "7f")
        self.min_slices = 1
        if num_slices is not None:
            _refuse(f"a multi-slice mesh (num_slices={num_slices})", "7f")
        self.num_slices = None
        self.device = device

    def resolve_sharding(self, num_devices: int) -> ShardingSpec:
        if isinstance(self.sharding, ShardingSpec):
            spec = (
                self.sharding.scaled_to(num_devices)
                if self.sharding.num_devices != num_devices
                else self.sharding
            )
        else:
            spec = ShardingSpec.preset(self.sharding, num_devices)
        overrides = {}
        if self.zero_stage is not None:
            overrides["zero_stage"] = int(self.zero_stage)
        if self.bucket_mb is not None:
            overrides["bucket_mb"] = float(self.bucket_mb)
        return dataclasses.replace(spec, **overrides) if overrides else spec
