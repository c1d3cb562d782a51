"""Distributed-training executor: the port's counterpart of
:mod:`maggy_tpu.core.executors.distributed`.

The JAX executor is a thread that drives every device of its host. Here
each partition is its own process, because NCCL takes one rank per process
and one card per rank: the experiment driver's thread for partition *i* spawns the
rank (``multiprocessing`` ``spawn`` context), waits for it under the
config's ``worker_timeout`` and raises on a non-zero exit: ``WorkerLost``
(a TRANSIENT death, which ``max_restarts`` may absorb) when the process was
killed or lost its substrate, else an error that aborts the run
(``Driver._worker_wrapper``). The rank process registers with the
driver's RPC server, waits for every rank, fetches ``EXEC_CONFIG``
(``MASTER_ADDR``, ``MASTER_PORT``, the world size and its rank), joins the
process group (NCCL on its card, gloo on the CPU), builds a
:class:`~maggy_tpu_torch.train.TrainContext` over the mesh, injects the
JAX executor's arguments into the ``train_fn``, runs it, sends ``FINAL``
and leaves the group.

Under elastic membership the rank runs JAX's reshape loop: a membership
exception out of ``fit`` (a slice lost, a slice rejoining, a newer epoch
announced by the heartbeat) makes the rank leave its process group, report
the event, wait at the driver's barrier under
``MAGGY_TPU_RESHAPE_TIMEOUT`` (seconds, default 120), adopt the new view,
re-run ``EXEC_CONFIG``, join the group the view describes (a fresh
rendezvous, at the new width, each rank at its place among the active
slices' ranks) and re-enter the ``train_fn`` with a module that is not yet
laid out, which resumes from the latest complete checkpoint. A rank whose
slice is not active stays parked at the barrier until a view takes its
slice back in, or until the run ends and releases it. A rank keeps its
device across epochs. Under elastic membership over a group
(``data_plane="auto"``, a group of one rank included) the ``trial_dir`` is
``worker_<rank in the group>``, so the group's rank 0, which writes the
checkpoints, finds them after a reshape whatever its partition.

In pod mode (:mod:`maggy_tpu_torch.core.pod`) the process is the rank: the
same body runs in it (``in_process=True``), under ``data_plane="auto"``
over the default group that
:func:`~maggy_tpu_torch.core.pod.initialize_data_plane` formed before
``lagom``. Under ``data_plane="local"``, and for the evaluator partition,
each rank forms a one-rank group of its own: a host-local context.

What the rank process receives is pickled, so the ``train_fn`` must be a
module-level function and the config's ``module``, ``dataset`` and
``process_data`` picklable (a deliberate divergence from the JAX thread:
the driver raises ``TypeError`` before any process starts).
"""

from __future__ import annotations

import copy
import os
import pickle
import socket as socket_mod
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

from maggy_tpu_torch import util
from maggy_tpu_torch.exceptions import RpcError, WorkerLost
# the config's worker_timeout bounds the whole rank
from maggy_tpu_torch.parallel.mesh import PROCESS_GROUP_TIMEOUT_S

# a rank process's exit code when its substrate, not its train_fn, failed
# (a WorkerLost): it sent no FINAL
WORKER_LOST_EXIT = 75
# the same, when the rank lost a peer inside a collective: a consequence of
# another rank's death, which the driver reads as no loss of its own
PEER_LOST_EXIT = 76


class PeerLost(WorkerLost):
    """A collective of this rank lost its peer: the death of another rank,
    not of this one (``peer_lost`` tells the driver so)."""

    peer_lost = True
# what gloo raises in a collective whose peer process died
_PEER_LOST_MARKS = ("Connection closed by peer", "Connection reset by peer", "remote worker crashing")


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
    in_process: bool = False,
    via_registry: bool = False,
) -> Callable[[], None]:
    """One partition's loop. By default the driver-side loop: spawn the
    rank, wait for it under ``config.worker_timeout``, raise unless it
    exits with 0 (``on_spawn(partition_id, process)`` lets the driver reap
    the process on an abort). With ``in_process`` (pod mode) the calling
    process is the rank, on ``devices[0]`` or its own card
    (:func:`_pod_device`)."""

    def _executor() -> None:
        import multiprocessing

        from maggy_tpu_torch.core.env import EnvSing

        if in_process:
            device = devices[0] if devices else _pod_device(config)
            _rank_body(train_fn, config, app_id, run_id, partition_id, tuple(server_addr), secret, device,
                       EnvSing.get_instance(), in_process=True, via_registry=via_registry)
            return
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
        if proc.exitcode == PEER_LOST_EXIT:
            raise PeerLost(f"rank {partition_id} lost a peer inside a collective (exit code {proc.exitcode})")
        if proc.exitcode < 0 or proc.exitcode == WORKER_LOST_EXIT:
            raise WorkerLost(f"rank {partition_id} was lost (exit code {proc.exitcode})")
        if proc.exitcode != 0:
            raise RuntimeError(f"rank {partition_id} exited with code {proc.exitcode}")

    return _executor


def _pod_device(config) -> torch.device:
    """A pod rank's device: the CPU under ``config.device="cpu"``, else its
    card: the first of ``MAGGY_TPU_WORKER_DEVICES``, else
    ``cuda:LOCAL_RANK`` (the launcher's ``--global-mesh`` exports it), else
    the current card. Without CUDA it raises."""
    device = getattr(config, "device", None)
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    lease = os.environ.get("MAGGY_TPU_WORKER_DEVICES", "").strip()
    if lease:
        from maggy_tpu_torch.core.pod import _worker_devices

        return _worker_devices(config)()[0]
    if "LOCAL_RANK" in os.environ:
        return util.resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return util.resolve_device(None)


def _rank_main(train_fn, config, app_id, run_id, partition_id, server_addr, secret, device, env) -> None:
    """The spawned rank process: :func:`_rank_body`, then exit 1 when the
    train_fn failed (after reporting it), ``WORKER_LOST_EXIT`` when the
    rank was lost (``PEER_LOST_EXIT`` when a peer was; no FINAL, the group
    left as it is: a group whose peer died may abort the process on its way
    down), else 0. A crash in native code prints every thread's Python
    stack first."""
    import faulthandler
    import sys

    faulthandler.enable()
    try:
        failed = _rank_body(train_fn, config, app_id, run_id, partition_id, server_addr, secret, device, env)
    except WorkerLost as e:
        print(f"maggy rank {partition_id}: {e}", file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(PEER_LOST_EXIT if isinstance(e, PeerLost) else WORKER_LOST_EXIT)
    if failed:
        raise SystemExit(1)


def _peer_lost(exc: BaseException) -> bool:
    """Whether ``exc`` (or its cause) is a collective that lost its peer: a
    ``torch.distributed`` backend error, or gloo's closed connection."""
    import torch.distributed as dist

    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, dist.DistError) or any(m in str(exc) for m in _PEER_LOST_MARKS):
            return True
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return False


def _rank_body(train_fn, config, app_id, run_id, partition_id, server_addr, secret, device, env,
               in_process: bool = False, via_registry: bool = False) -> bool:
    """One rank, from registration to FINAL. Returns whether the train_fn
    failed (reported in its FINAL). Raises ``WorkerLost`` without a FINAL
    when the rank's substrate was lost: the train_fn raised ``WorkerLost``
    (in workers mode, a ``SliceLost`` of the rank's own slice), or a
    collective lost a peer (``PeerLost``). Under elastic membership it runs
    the reshape loop (module docstring)."""
    from maggy_tpu_torch import telemetry
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.pod import _connect_with_deadline
    from maggy_tpu_torch.exceptions import EarlyStopException
    from maggy_tpu_torch.reporter import Reporter, capture_prints
    from maggy_tpu_torch.resilience.membership import (
        MembershipChanged,
        MembershipMonitor,
        MembershipView,
        SliceLost,
        SliceRejoin,
    )

    if not in_process:
        env_mod.set_instance(env)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif not in_process and not os.environ.get("OMP_NUM_THREADS"):  # gloo ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, config.num_executors or 1)))
    exp_dir = env.experiment_dir(app_id, run_id)
    reporter = Reporter(log_file=os.path.join(exp_dir, f"executor_{partition_id}.log"), partition_id=partition_id)
    tel = telemetry.worker_telemetry(partition_id, exp_dir, role="dist", env=env)
    telemetry.set_current(tel)
    # pod processes start together: the driver may need seconds before it
    # listens, so retry well past the Client's own attempts
    client = _connect_with_deadline(
        server_addr[0], server_addr[1], partition_id, secret,
        float(os.environ.get("MAGGY_TPU_CONNECT_TIMEOUT", "120")), hb_interval=config.hb_interval,
        via_registry=via_registry,
    )
    client.telemetry = tel
    error = None
    formed = lost = False
    try:
        client.register(meta={"host": socket_mod.gethostname(), "devices": [str(device)]})
        client.start_heartbeat(reporter)
        with tel.span("await_reservations"):
            client.await_reservations()
        exec_config = client.get_message("EXEC_CONFIG")
        # elastic membership: the monitor holds the view this rank's mesh
        # is built for; heartbeats report its epoch, and a RESHAPE reply
        # flags it for fit's next step boundary
        monitor = None
        if exec_config.get("membership"):
            view = MembershipView.from_dict(exec_config["membership"])
            monitor = MembershipMonitor(view, self_slice=partition_id if view.mode == "workers" else None)
            client.membership = monitor
        my_slice = partition_id // int(exec_config.get("ranks_per_slice", 1))
        reporter.reset(trial_id=f"dist_{partition_id}")
        dataset = config.dataset
        if config.process_data is not None:
            dataset = config.process_data(dataset)
        metric, outputs = None, {}
        while True:
            if monitor is not None and my_slice not in monitor.active:
                # a dropped slice's rank, parked at the barrier
                exec_config = _park(client, monitor, my_slice, reporter, partition_id)
                if exec_config is None:
                    break  # released: a FINAL without a result
                continue
            with tel.span("build_context"):
                ctx, formed = _build_context(exec_config, config, partition_id, device, in_process, monitor,
                                             reporter)
            # under elastic membership over a group (of any width, one
            # rank too) the chief's directory is worker_0 whichever
            # partition holds rank 0: the survivors of a drop of the old
            # rank 0 find its checkpoint
            grouped = monitor is not None and formed and config.data_plane != "local"
            worker_dir = os.path.join(exp_dir, f"worker_{ctx.process_index if grouped else partition_id}")
            module = _apply_model_policies(config.module, config.mixed_precision, config.remat)
            if monitor is not None and module is not None and module is config.module:
                # FSDP2 and DTensor lay a module out in place: each entry
                # of the train_fn gets one that is not laid out yet
                module = copy.deepcopy(module)
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
            try:
                kwargs = util.inject_kwargs(train_fn, available)
                with tel.span("train_fn", partition=partition_id), capture_prints(reporter):
                    retval = train_fn(**kwargs)
                if retval is not None:
                    # the evaluator's outputs are free-form (no optimization
                    # key needed) but persist like every worker's
                    metric, outputs = util.normalize_return_val(retval, "metric",
                                                                require_metric=ctx.role != "evaluator")
                    util.persist_outputs(outputs, metric, worker_dir)
                break
            except EarlyStopException as e:
                metric = e.metric
                outputs = {"metric": metric}
                break
            except (SliceLost, SliceRejoin, MembershipChanged) as e:
                if monitor is None or (isinstance(e, SliceLost) and e.slice_id == monitor.self_slice):
                    # not elastic, or this worker IS the lost slice: it dies
                    # like one, and the driver's death hook makes it a drop
                    lost = True
                    raise
                event = e.with_traceback(None)
            except WorkerLost:
                # worker death (preemption, chaos kill): no FINAL; the
                # driver's restart or membership path takes over
                lost = True
                raise
            except Exception as e:  # noqa: BLE001 - reported to the driver, which fails the run
                if ctx.num_processes > 1 and _peer_lost(e):
                    # a peer died under this rank's collective: the substrate,
                    # not this rank's train_fn, failed
                    lost = True
                    raise PeerLost(f"rank {partition_id} lost a peer inside a collective: {e}") from e
                error = f"{type(e).__name__}: {e}"
                reporter.log(f"Distributed worker {partition_id} failed:\n{traceback.format_exc()}")
                break
            # the reshape loop: free what the entry built (its laid-out
            # module, its state, the mesh) while its group still exists, so
            # that its card memory is back before the next entry builds its
            # own and nothing of it outlives the communicators it used; leave
            # the group at this step boundary; report the event, wait out the
            # barrier, then rebuild for the new view and re-enter the train_fn
            del kwargs, available, module, ctx
            _release(device)
            if formed:
                from maggy_tpu_torch.parallel.mesh import leave_group

                leave_group()
                formed = False
            exec_config = _reshape(client, monitor, event, tel, reporter, partition_id)
        tel.flush()  # events are durable before FINAL ships
        client.finalize_metric(f"dist_{partition_id}", metric, outputs=util._jsonify(outputs), error=error)
    finally:
        client.stop()
        reporter.close()
        telemetry.set_current(None)
        tel.close()
        import torch.distributed as dist

        if formed and not lost and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return error is not None


def _release(device: torch.device) -> None:
    """Collect the garbage a train_fn entry left (reference cycles of a
    laid-out module and its optimizer) and, on a card, wait for its work and
    return its cached memory."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _barrier_poll(client, acked: int):
    """One poll of the driver's reshape barrier, acking ``acked``:
    ``(view, reply)``; raises when the driver aborted the run."""
    from maggy_tpu_torch.resilience.membership import MembershipView

    reply = client.request({"type": "MEMBERSHIP", "epoch": acked})
    if reply.get("aborted"):
        raise RpcError("membership reshape aborted by the driver (see the experiment error, e.g. a "
                       "min_slices violation)")
    return MembershipView.from_dict(reply["view"]), reply


def _reshape(client, monitor, event, tel, reporter, partition_id: int):
    """One membership transition on the rank's side (JAX's ``_reshape``):
    report the slice event this rank observed, wait at the reshape barrier
    until every member acked the new epoch, adopt the view and re-run the
    ``EXEC_CONFIG`` exchange for its layout."""
    from maggy_tpu_torch.resilience.membership import SliceLost, SliceRejoin

    old_epoch = monitor.epoch
    kind = "drop" if isinstance(event, SliceLost) else "rejoin" if isinstance(event, SliceRejoin) else None
    if kind is not None:
        client.request({"type": "SLICE_EVENT", "kind": kind, "slice": event.slice_id, "step": event.step})
    reporter.log(f"Worker {partition_id}: membership event ({event}); awaiting the reshape barrier")
    t0 = time.perf_counter()
    deadline = time.time() + float(os.environ.get("MAGGY_TPU_RESHAPE_TIMEOUT", "120"))
    acked = old_epoch
    while True:
        view, reply = _barrier_poll(client, acked)
        acked = view.epoch
        if view.epoch > old_epoch and reply.get("ready"):
            monitor.adopt(view)
            break
        if time.time() > deadline:
            raise RpcError(f"reshape barrier for epoch > {old_epoch} did not complete within "
                           "MAGGY_TPU_RESHAPE_TIMEOUT")
        time.sleep(0.01)
    tel.gauge("resilience.membership_epoch", view.epoch)
    tel.gauge("resilience.active_slices", view.n_active)
    reporter.log(
        f"Worker {partition_id}: reshaped to membership epoch {view.epoch} (active slices "
        f"{list(view.active)}/{view.total_slices}, {(time.perf_counter() - t0) * 1e3:.0f}ms barrier); "
        "resuming from the latest complete checkpoint"
    )
    return client.get_message("EXEC_CONFIG")


def _park(client, monitor, my_slice: int, reporter, partition_id: int):
    """A rank whose slice left the membership: out of every group, it keeps
    acking the barrier until a view takes its slice back in (then the
    epoch's ``EXEC_CONFIG``) or the driver releases it (None)."""
    reporter.log(f"Worker {partition_id}: slice {my_slice} is not active; parked at the reshape barrier")
    acked = monitor.epoch
    while True:
        view, reply = _barrier_poll(client, acked)
        acked = view.epoch
        if reply.get("release"):
            return None
        if my_slice in view.active and view.epoch > monitor.epoch and reply.get("ready"):
            monitor.adopt(view)
            reporter.log(f"Worker {partition_id}: slice {my_slice} rejoins at membership epoch {view.epoch}")
            return client.get_message("EXEC_CONFIG")
        time.sleep(0.05)


def _build_context(exec_config, config, partition_id: int, device: torch.device, in_process: bool,
                   monitor=None, reporter=None):
    """This rank's TrainContext, with JAX's roles, and whether this call
    formed the process group (the rank leaves it after FINAL, or at a
    reshape):

    * the evaluator partition, and every rank under ``data_plane="local"``:
      a one-rank group of this process, a host-local context;
    * under elastic membership with ``num_slices`` (mode ``"sim"``): the
      group of the active slices' ranks ``EXEC_CONFIG`` describes, and a
      sliced context over it (``TrainContext.create_sliced``); in workers
      mode the group of the active ranks;
    * under ``data_plane="auto"`` the launcher's group when one exists (pod
      mode), else the group ``EXEC_CONFIG`` describes, which the spawned
      rank joins. A pod rank never forms it late: with no group and more
      than one process it raises, as JAX's executor does."""
    import torch.distributed as dist

    from maggy_tpu_torch.train.trainer import TrainContext

    role = "chief" if partition_id == 0 else "worker"
    if exec_config.get("evaluator_partition") == partition_id or config.data_plane == "local":
        if exec_config.get("evaluator_partition") == partition_id:
            role = "evaluator"
        _init_group(device, "127.0.0.1", 0, 0, 1)
        return TrainContext.create(config.resolve_sharding(1), devices=[device], role=role,
                                   membership=monitor), True
    if monitor is not None and not in_process:
        # a group of the active ranks at the epoch's width, each rank at its
        # place among them, on the epoch's fresh rendezvous
        rank, world = int(exec_config["rank"]), int(exec_config["world_size"])
        t0 = time.perf_counter()
        _init_group(device, exec_config["master_addr"], exec_config["master_port"], rank, world)
        view = monitor.view
        role = "chief" if rank == 0 else "worker"
        if view.mode == "sim":
            per = int(exec_config["ranks_per_slice"])
            ctx = TrainContext.create_sliced(config.resolve_sharding(per), total_slices=view.total_slices,
                                             active=view.active, devices=[device], role=role, membership=monitor)
        else:
            ctx = TrainContext.create(config.resolve_sharding(world), devices=[device], role=role,
                                      membership=monitor)
        if reporter is not None:
            reporter.log(f"Worker {partition_id}: formed the group of {world} ranks as rank {rank} at membership "
                         f"epoch {view.epoch} in {(time.perf_counter() - t0) * 1e3:.1f} ms")
        return ctx, True
    if dist.is_available() and dist.is_initialized():
        spec = config.resolve_sharding(dist.get_world_size())
        return TrainContext.create(spec, devices=[device], role=role, membership=monitor), False
    num_processes = int(exec_config.get("num_processes", 1))
    if in_process and num_processes > 1:
        # the launcher's rendezvous moment (reference
        # torch_dist_executor.py:121-140) has passed: forming the group now
        # from one rank cannot match the others, and unsynchronized
        # replicas would be worse than failing
        raise RuntimeError(
            "data_plane='auto' on a multi-process pod requires "
            "maggy_tpu_torch.initialize_data_plane() before lagom() (call it at "
            "the top of your script or via the launcher's --global-mesh), or pass "
            "DistributedConfig(data_plane='local') for independent "
            "per-process replicas."
        )
    if in_process:
        rank, world, addr, port = 0, 1, "127.0.0.1", 0
    else:
        rank, world = int(exec_config["rank"]), int(exec_config["world_size"])
        addr, port = exec_config["master_addr"], exec_config["master_port"]
        if rank != partition_id:
            raise RuntimeError(f"EXEC_CONFIG gave partition {partition_id} rank {rank}")
    _init_group(device, addr, port, rank, world)
    return TrainContext.create(config.resolve_sharding(world), devices=[device], role=role,
                               membership=monitor), True


def _init_group(device: torch.device, addr: str, port: int, rank: int, world: int) -> None:
    """Join the process group (NCCL on a card, gloo on the CPU) at
    ``tcp://addr:port``; a one-rank group rendezvous in this process.

    The NCCL group is bound to no device (the rank's card is the current
    device; the communicators are made at their first collective): a rank
    may form groups again in its process (elastic membership), and the
    subgroups of a device-bound default group are NCCL communicator splits,
    which on H100s with NCCL 2.28.9 crashed the process when made after a
    group of the process had been destroyed (SIGSEGV in ``split_group``,
    inside ``init_device_mesh``); unbound, every subgroup is a communicator
    of its own."""
    import datetime

    import torch.distributed as dist

    os.environ.update(
        MASTER_ADDR=str(addr), MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
        LOCAL_RANK=str(device.index if device.index is not None else 0),
    )
    kw = dict(rank=rank, world_size=world, timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    if world == 1:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = f"tcp://{addr}:{port}"
    if device.type == "cuda":
        dist.init_process_group("nccl", **kw)
    else:
        dist.init_process_group("gloo", **kw)


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
