"""Distributed-training experiment config: the port's copy of
:mod:`maggy_tpu.config.distributed`, plus the port's ``device``.

The config declares a sharding layout (a
:class:`~maggy_tpu_torch.parallel.spec.ShardingSpec` or a preset name) and
``lagom`` runs one process per CUDA card, each an NCCL rank on a mesh of
that layout (``device="cpu"``: gloo ranks on the CPU). ``zero_lvl`` maps
onto the layouts as in JAX: 0 → dp, 2 or 3 → fsdp, 1 → dp with
``zero_stage=1`` (ZeRO-1 over ``data``); ``zero_stage`` and ``bucket_mb``
are stamped onto the resolved spec, whose trainer they configure
(:meth:`~maggy_tpu_torch.train.TrainContext.trainer`). Pod mode
(``driver_addr``), ``data_plane="local"``, the evaluator,
``max_restarts`` and elastic membership (``elastic``, ``num_slices``,
``min_slices``) take the JAX config's meanings, with slices made of rank
processes (:mod:`maggy_tpu_torch.core.driver.distributed`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Union

from maggy_tpu_torch.config.base import LagomConfig
from maggy_tpu_torch.parallel.spec import ShardingSpec


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
            visible card; 1 with ``device="cpu"``). Env override:
            ``MAGGY_TPU_NUM_EXECUTORS`` (the launcher exports it).
        :param driver_addr: pod mode: every process runs the same script;
            the others connect to the driver here ("host:port"; env
            override ``MAGGY_TPU_DRIVER``, the secret rides
            ``MAGGY_TPU_SECRET``). The driver runs partition 0 in its own
            process, which is that rank.
        :param data_plane: "auto", one process group over every rank
            (formed by the driver's spawned ranks, or in pod mode by
            :func:`~maggy_tpu_torch.core.pod.initialize_data_plane` before
            ``lagom``); "local", each rank its own one-rank group
            (independent replicas).
        :param worker_timeout: seconds a rank may run before the driver
            kills it and fails the run; in pod mode, how long a registered
            worker may stay silent.
        :param coordinator_port: the rendezvous port (``MASTER_PORT``);
            default a free port. Env override:
            ``MAGGY_TPU_COORDINATOR_PORT``.
        :param evaluator: the last partition evaluates, outside the
            training group (``ctx.role == "evaluator"``; its outputs land
            under ``result["evaluator"]``); needs ``num_executors >= 2``
            and ``data_plane="local"``.
        :param max_restarts: restarts of a rank lost to a TRANSIENT death
            (never a train_fn exception); the relaunched train_fn resumes
            from its latest checkpoint. Under ``data_plane="auto"`` with
            more than one rank every rank is relaunched together, for one
            slot. Env override: ``MAGGY_TPU_MAX_RESTARTS``.
        :param elastic: elastic membership: a lost slice leaves the mesh
            (the survivors go on at the reduced width from the checkpoint
            every member agrees on) and a returning one rejoins it, without
            a ``max_restarts`` slot. The train_fn needs a checkpointer and
            ``fit(resume="auto")``.
        :param min_slices: the fewest active slices; a drop below it fails
            the run with ``MembershipViolation``.
        :param num_slices: the launch's slices, each a contiguous block of
            ``num_executors / num_slices`` ranks of one process group
            (``data_plane="auto"``), under the mesh's outer ``slice`` axis.
            None: each rank is one slice of its own.
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
        self.driver_addr = driver_addr
        if data_plane not in ("auto", "local"):
            raise ValueError("data_plane must be 'auto' or 'local'")
        self.data_plane = data_plane
        self.worker_timeout = float(worker_timeout)
        if coordinator_port is None and os.environ.get("MAGGY_TPU_COORDINATOR_PORT"):
            coordinator_port = int(os.environ["MAGGY_TPU_COORDINATOR_PORT"])
        self.coordinator_port = coordinator_port
        self.evaluator = bool(evaluator)
        if max_restarts == 0 and os.environ.get("MAGGY_TPU_MAX_RESTARTS"):
            max_restarts = int(os.environ["MAGGY_TPU_MAX_RESTARTS"])
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.max_restarts = int(max_restarts)
        self.elastic = bool(elastic)
        if min_slices < 1:
            raise ValueError("min_slices must be >= 1")
        self.min_slices = int(min_slices)
        if num_slices is not None and num_slices < 1:
            raise ValueError("num_slices must be >= 1")
        self.num_slices = num_slices
        if self.evaluator and self.elastic:
            raise ValueError(
                "elastic=True does not compose with evaluator=True: the "
                "evaluator partition sits outside the training membership"
            )
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
