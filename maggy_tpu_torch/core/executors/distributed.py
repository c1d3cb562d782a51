"""Distributed-training executor: the port's counterpart of
:mod:`maggy_tpu.core.executors.distributed`.

The JAX executor is a thread that drives every device of its host. Here
each partition is its own process, because NCCL takes one rank per process
and one card per rank: the experiment driver's thread for partition *i* spawns the
rank (``multiprocessing`` ``spawn`` context), waits for it under the
config's ``worker_timeout`` and raises on a non-zero exit, which aborts the
run (``Driver._worker_wrapper``). The rank process registers with the
driver's RPC server, waits for every rank, fetches ``EXEC_CONFIG``
(``MASTER_ADDR``, ``MASTER_PORT``, the world size and its rank), joins the
process group (NCCL on its card, gloo on the CPU), builds a
:class:`~maggy_tpu_torch.train.TrainContext` over the mesh, injects the
JAX executor's arguments into the ``train_fn``, runs it, sends ``FINAL``
and leaves the group.

What the rank process receives is pickled, so the ``train_fn`` must be a
module-level function and the config's ``module``, ``dataset`` and
``process_data`` picklable (a deliberate divergence from the JAX thread:
the driver raises ``TypeError`` before any process starts).
"""

from __future__ import annotations

import os
import pickle
import socket as socket_mod
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

from maggy_tpu_torch import util
# the config's worker_timeout bounds the whole rank
from maggy_tpu_torch.parallel.mesh import PROCESS_GROUP_TIMEOUT_S


def check_picklable(train_fn: Callable, config) -> None:
    """Raise ``TypeError`` unless the rank processes can be handed
    ``train_fn`` and the config: a lambda, a closure or a generator
    cannot cross a spawn."""
    for what, obj in (("train_fn", train_fn), ("the config", config)):
        try:
            pickle.dumps(obj)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"{what} cannot be pickled ({type(e).__name__}: {e}); lagom(train_fn, DistributedConfig) "
                "runs each rank in a spawned process: use a module-level train_fn and a picklable "
                "module, dataset (arrays or a module-level factory) and process_data"
            ) from None


def dist_executor_fn(
    train_fn: Callable,
    config,
    app_id: str,
    run_id: int,
    partition_id: int,
    server_addr,
    secret: str,
    devices: Optional[List[torch.device]] = None,
    on_spawn: Optional[Callable[[int, Any], None]] = None,
) -> Callable[[], None]:
    """The driver-side loop of one partition: spawn its rank, wait for it
    under ``config.worker_timeout``, raise unless it exits with 0.
    ``on_spawn(partition_id, process)`` lets the driver reap the process
    on an abort."""

    def _executor() -> None:
        import multiprocessing

        from maggy_tpu_torch.core.env import EnvSing

        spawn = multiprocessing.get_context("spawn")
        proc = spawn.Process(
            target=_rank_main,
            args=(train_fn, config, app_id, run_id, partition_id, tuple(server_addr), secret,
                  str((devices or [torch.device("cpu")])[0]), EnvSing.get_instance()),
            name=f"maggy-rank-{partition_id}",
        )
        proc.start()
        if on_spawn is not None:
            on_spawn(partition_id, proc)
        deadline = time.monotonic() + float(config.worker_timeout)
        while proc.is_alive() and time.monotonic() < deadline:
            proc.join(timeout=0.5)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise TimeoutError(f"rank {partition_id} still ran after worker_timeout={config.worker_timeout} s")
        if proc.exitcode != 0:
            raise RuntimeError(f"rank {partition_id} exited with code {proc.exitcode}")

    return _executor


def _rank_main(train_fn, config, app_id, run_id, partition_id, server_addr, secret, device, env) -> None:
    """The rank process: everything between registration and FINAL. Exits
    with 1 when the train_fn failed (after reporting it), else 0."""
    from maggy_tpu_torch import telemetry
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core import rpc
    from maggy_tpu_torch.exceptions import EarlyStopException
    from maggy_tpu_torch.reporter import Reporter, capture_prints

    env_mod.set_instance(env)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # gloo ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, config.num_executors or 1)))
    exp_dir = env.experiment_dir(app_id, run_id)
    reporter = Reporter(log_file=os.path.join(exp_dir, f"executor_{partition_id}.log"), partition_id=partition_id)
    tel = telemetry.worker_telemetry(partition_id, exp_dir, role="dist", env=env)
    telemetry.set_current(tel)
    client = rpc.Client(server_addr, partition_id, secret, hb_interval=config.hb_interval, telemetry=tel)
    error = None
    try:
        client.register(meta={"host": socket_mod.gethostname(), "devices": [str(device)]})
        client.start_heartbeat(reporter)
        with tel.span("await_reservations"):
            client.await_reservations()
        exec_config = client.get_message("EXEC_CONFIG")
        reporter.reset(trial_id=f"dist_{partition_id}")
        worker_dir = os.path.join(exp_dir, f"worker_{partition_id}")
        with tel.span("build_context"):
            ctx = _join(exec_config, config, partition_id, device)
        module = _apply_model_policies(config.module, config.mixed_precision, config.remat)
        dataset = config.dataset
        if config.process_data is not None:
            dataset = config.process_data(dataset)
        rng = torch.Generator(device=device)
        rng.manual_seed(config.seed)
        available = {
            "module": module,
            "model": module,
            "dataset": dataset,
            "hparams": dict(getattr(config, "hparams", None) or {}),
            "reporter": reporter,
            "ctx": ctx,
            "train_ctx": ctx,
            "mesh": ctx.mesh,
            "trial_dir": worker_dir,
            "rng": rng,
        }
        metric, outputs = None, {}
        try:
            kwargs = util.inject_kwargs(train_fn, available)
            with tel.span("train_fn", partition=partition_id), capture_prints(reporter):
                retval = train_fn(**kwargs)
            if retval is not None:
                metric, outputs = util.normalize_return_val(retval, "metric")
                util.persist_outputs(outputs, metric, worker_dir)
        except EarlyStopException as e:
            metric = e.metric
            outputs = {"metric": metric}
        except Exception as e:  # noqa: BLE001 - reported to the driver, which fails the run
            error = f"{type(e).__name__}: {e}"
            reporter.log(f"Distributed worker {partition_id} failed:\n{traceback.format_exc()}")
        tel.flush()  # events are durable before FINAL ships
        client.finalize_metric(f"dist_{partition_id}", metric, outputs=util._jsonify(outputs), error=error)
    finally:
        client.stop()
        reporter.close()
        telemetry.set_current(None)
        tel.close()
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    if error is not None:
        raise SystemExit(1)


def _join(exec_config, config, partition_id: int, device: torch.device):
    """Join the process group EXEC_CONFIG describes (NCCL on a card, gloo
    on the CPU) and build the rank's TrainContext over it."""
    import datetime

    import torch.distributed as dist

    from maggy_tpu_torch.train.trainer import TrainContext

    rank, world = int(exec_config["rank"]), int(exec_config["world_size"])
    if rank != partition_id:
        raise RuntimeError(f"EXEC_CONFIG gave partition {partition_id} rank {rank}")
    os.environ.update(
        MASTER_ADDR=str(exec_config["master_addr"]), MASTER_PORT=str(exec_config["master_port"]),
        RANK=str(rank), WORLD_SIZE=str(world),
        LOCAL_RANK=str(device.index if device.index is not None else 0),
    )
    kw = dict(
        init_method=f"tcp://{exec_config['master_addr']}:{exec_config['master_port']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S),
    )
    if device.type == "cuda":
        dist.init_process_group("nccl", device_id=device, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    spec = config.resolve_sharding(world)
    return TrainContext.create(spec, devices=[device], role="chief" if rank == 0 else "worker")


def _apply_model_policies(module, mixed_precision: bool, remat: bool):
    """The config's dtype and remat policy, for models with a ``cfg``
    dataclass (the Decoder): a rebuild on the meta device with
    ``dtype=bfloat16`` (``mixed_precision``) or float32 and ``remat`` set,
    whose weights ``Trainer.make_state`` materialises. Other modules keep
    their own policy, with a warning when one was asked for."""
    import dataclasses
    import logging

    cfg = getattr(module, "cfg", None)
    if cfg is None or not dataclasses.is_dataclass(cfg):
        if module is not None and (not mixed_precision or remat):
            logging.getLogger(__name__).warning(
                "mixed_precision/remat requested but %s has no cfg dataclass; "
                "module keeps its own dtype/remat policy.",
                type(module).__name__,
            )
        return module
    updates = {}
    if hasattr(cfg, "dtype"):
        updates["dtype"] = torch.bfloat16 if mixed_precision else torch.float32
    if hasattr(cfg, "remat"):
        updates["remat"] = bool(remat or getattr(cfg, "remat", False))
    if not updates:
        return module
    return type(module)(dataclasses.replace(cfg, **updates), device="meta")
