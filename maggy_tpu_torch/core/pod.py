"""Pod execution: every process or host runs the same user script; the
port's copy of :mod:`maggy_tpu.core.pod`.

The standard launch starts one identical Python process per host (or per
card), so the train_fn exists everywhere by construction.
``lagom(train_fn, config)`` therefore behaves per role:

* **process 0** (or ``MAGGY_TPU_ROLE=driver``): the driver and its own
  partition 0.
* **the other processes** (``MAGGY_TPU_ROLE=worker``, or a non-zero rank of
  the default process group): no driver; a worker connects to process 0's
  driver over the host network, runs its executor and returns its role.

Bootstrap contract: under ``data_plane="auto"`` the launcher (or the top of
the user script) calls :func:`initialize_data_plane` before ``lagom``: one
``torch.distributed`` process group over ``tcp://MAGGY_TPU_COORDINATOR``,
NCCL with each process on its own card (gloo with ``device="cpu"``). The
framework never forms it late and fails loudly instead of training
unsynchronized replicas. The driver address travels out of band:
``MAGGY_TPU_DRIVER=host:port`` and ``MAGGY_TPU_SECRET``, or
``config.driver_addr``, or the driver registry under the experiment root.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple


def initialize_data_plane(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Form the global data plane: ``torch.distributed.init_process_group``
    over ``tcp://<coordinator>``, before ``lagom``.

    Arguments default from the launcher's environment
    (``MAGGY_TPU_COORDINATOR``, ``MAGGY_TPU_NUM_EXECUTORS``,
    ``MAGGY_TPU_PARTITION``, exported by ``python -m maggy_tpu_torch.run
    --global-mesh``). Returns False (and does nothing) when no coordinator
    is configured, so the same script runs as one process unchanged.
    ``device=None`` binds the process to ``cuda:LOCAL_RANK`` (else
    ``cuda:process_id``) and forms an NCCL group; without CUDA it raises.
    ``device="cpu"`` forms a gloo group. Raises if a default process group
    already exists."""
    coordinator = coordinator or os.environ.get("MAGGY_TPU_COORDINATOR")
    if not coordinator:
        return False
    num_processes = int(
        num_processes if num_processes is not None else os.environ.get("MAGGY_TPU_NUM_EXECUTORS", "1")
    )
    process_id = int(process_id if process_id is not None else os.environ.get("MAGGY_TPU_PARTITION", "0"))
    import datetime

    import torch
    import torch.distributed as dist

    from maggy_tpu_torch import telemetry
    from maggy_tpu_torch.parallel.mesh import PROCESS_GROUP_TIMEOUT_S
    from maggy_tpu_torch.util import resolve_device

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "initialize_data_plane() must run before any torch.distributed process group "
            "exists (move it to the top of the script)"
        )
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass initialize_data_plane(device='cpu') for gloo ranks on the CPU"
            )
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id)))
    device = resolve_device(device)
    tel = telemetry.get()
    t0 = time.perf_counter()
    kw = dict(
        init_method=f"tcp://{coordinator}", rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S),
    )
    with tel.span("data_plane_init", coordinator=coordinator, rank=process_id):
        if device.type == "cuda":
            if device.index is None or device.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {process_id} is bound to {device}, but {torch.cuda.device_count()} "
                    "CUDA card(s) are visible"
                )
            torch.cuda.set_device(device)
            os.environ["LOCAL_RANK"] = str(device.index)  # TrainContext.create reads it
            dist.init_process_group("nccl", device_id=device, **kw)
        else:
            dist.init_process_group("gloo", **kw)
    tel.gauge("data_plane_init_ms", (time.perf_counter() - t0) * 1e3)
    return True


def driver_address(config) -> Optional[str]:
    """The single source of pod-mode detection for driver AND workers."""
    return os.environ.get("MAGGY_TPU_DRIVER") or getattr(config, "driver_addr", None)


def discover_driver(app_id: str) -> Optional[dict]:
    """A running driver's {host, port, secret} by app id from the Env's
    driver registry (shared storage): the fallback when MAGGY_TPU_DRIVER /
    MAGGY_TPU_SECRET are not set. Only ``scope="pod"`` records qualify:
    "local" records advertise a loopback address for monitor attach and
    would send a remote worker to its own machine. A SIGKILLed driver
    cannot unregister, so a record can outlive its driver; a worker that
    found a dead record fails at the connect deadline naming the registry
    path (:func:`_connect_with_deadline`)."""
    from maggy_tpu_torch.core.env import EnvSing

    rec = EnvSing.get_instance().lookup_driver(app_id)
    if rec is not None and rec.get("scope", "pod") != "pod":
        return None
    return rec


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"MAGGY_TPU_DRIVER/driver_addr must be 'host:port', got {addr!r}")
    return host or "127.0.0.1", int(port)


class WorkerRole(NamedTuple):
    host: str
    port: int
    secret: str
    via_registry: bool = False


def _process_index() -> int:
    """This process's rank: the default process group's when one exists,
    else ``MAGGY_TPU_PARTITION`` (0 when unset)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("MAGGY_TPU_PARTITION", "0"))


def worker_role(config) -> Optional[WorkerRole]:
    """A :class:`WorkerRole` if this process should run as a pod worker,
    else None (run the driver)."""
    explicit_role = os.environ.get("MAGGY_TPU_ROLE")
    if explicit_role == "driver":
        return None
    addr = driver_address(config)
    discovered = None
    app_id = os.environ.get("MAGGY_TPU_APP_ID")
    if not addr and app_id:
        # no explicit address: poll the registry. An explicit worker waits
        # out the driver's start (the record is written once its RPC server
        # is up); without the wait it would become a second driver
        deadline = time.time() + (
            float(os.environ.get("MAGGY_TPU_CONNECT_TIMEOUT", "120")) if explicit_role == "worker" else 0.0
        )
        while True:
            discovered = discover_driver(app_id)
            if discovered or time.time() >= deadline:
                break
            time.sleep(0.5)
        if discovered:
            addr = f"{discovered['host']}:{discovered['port']}"
    if not addr:
        if explicit_role == "worker":
            raise RuntimeError(
                "MAGGY_TPU_ROLE=worker but no driver address: set "
                "MAGGY_TPU_DRIVER=host:port, or make the driver's registry "
                "record reachable (MAGGY_TPU_APP_ID + the driver's "
                "MAGGY_TPU_LOG_ROOT on shared storage)."
            )
        return None
    if explicit_role != "worker" and _process_index() == 0:
        # rank 0 of the launcher's process group (or partition 0) drives
        return None
    # via_registry marks the ADDRESS as registry-sourced (the stale-record
    # hint on a connect timeout)
    addr_from_registry = discovered is not None
    secret = os.environ.get("MAGGY_TPU_SECRET", "")
    if not secret:
        if discovered is None and app_id:
            discovered = discover_driver(app_id)
        if discovered:
            secret = discovered.get("secret", "")
    if not secret:
        raise RuntimeError(
            "Pod worker role needs MAGGY_TPU_SECRET (printed by the driver) "
            "or a driver-registry record reachable via MAGGY_TPU_APP_ID."
        )
    host, port = _parse_addr(addr)
    return WorkerRole(host, port, secret, via_registry=addr_from_registry)


def partition_id() -> int:
    if "MAGGY_TPU_PARTITION" in os.environ:
        return int(os.environ["MAGGY_TPU_PARTITION"])
    return _process_index()


def _connect_with_deadline(
    host: str,
    port: int,
    pid: int,
    secret: str,
    deadline_s: float,
    hb_interval: float = 1.0,
    via_registry: bool = False,
):
    """Pod processes start together and the driver may need seconds before
    it listens: retry well past the Client's own attempts (0.2 s, × 1.5 up
    to 5 s). ``via_registry`` marks an address from the discovery registry,
    so the timeout error can point at a possibly stale record."""
    from maggy_tpu_torch import telemetry
    from maggy_tpu_torch.core import rpc
    from maggy_tpu_torch.exceptions import RpcError

    start = time.perf_counter()
    deadline = time.time() + deadline_s
    delay = 0.2
    while True:
        try:
            client = rpc.Client((host, port), pid, secret, hb_interval)
            telemetry.get().gauge("driver_connect_ms", (time.perf_counter() - start) * 1e3)
            return client
        except RpcError as e:
            if time.time() > deadline:
                hint = ""
                if via_registry:
                    from maggy_tpu_torch.core.env import EnvSing

                    app_id = os.environ.get("MAGGY_TPU_APP_ID", "<app>")
                    hint = (
                        f" (address came from the driver registry "
                        f"{EnvSing.get_instance().driver_registry_path(app_id)};"
                        f" the record may be stale — a SIGKILLed driver cannot"
                        f" unregister)"
                    )
                raise RpcError(
                    f"Could not reach driver at {host}:{port} within {deadline_s:.0f}s{hint}: {e}"
                ) from e
            time.sleep(delay)
            delay = min(delay * 1.5, 5.0)


def _bootstrap_ids(host: str, port: int, pid: int, secret: str, via_registry: bool) -> Tuple[str, int]:
    """The driver's app/run ids, so this worker's files land in the
    driver's experiment directory (the env vars win)."""
    from maggy_tpu_torch import util

    connect_timeout = float(os.environ.get("MAGGY_TPU_CONNECT_TIMEOUT", "120"))
    app_id = os.environ.get("MAGGY_TPU_APP_ID")
    run_id = os.environ.get("MAGGY_TPU_RUN_ID")
    if app_id is None or run_id is None:
        probe = _connect_with_deadline(host, port, pid, secret, connect_timeout, via_registry=via_registry)
        try:
            cfg_reply = probe._request({"type": "EXEC_CONFIG"})
            app_id = app_id or cfg_reply.get("app_id") or util.new_app_id()
            run_id = run_id or cfg_reply.get("run_id") or 1
        finally:
            probe.stop()
    return app_id, int(run_id)


def run_worker(train_fn: Callable, config, host: str, port: int, secret: str, via_registry: bool = False) -> Any:
    """Run this process as one distributed pod worker, in this process (it
    is the rank); returns its role."""
    from maggy_tpu_torch.core.executors.distributed import dist_executor_fn

    pid = partition_id()
    app_id, run_id = _bootstrap_ids(host, port, pid, secret, via_registry)
    executor = dist_executor_fn(
        train_fn=train_fn,
        config=config,
        app_id=app_id,
        run_id=run_id,
        partition_id=pid,
        server_addr=(host, port),
        secret=secret,
        devices=None,  # the process's own card (or the CPU)
        in_process=True,
        via_registry=via_registry,
    )
    executor()
    return {"role": "worker", "partition_id": pid}


def _worker_devices(config=None):
    """This trial worker's lease. None (the default): the config's lease
    of the host (its cards, or the CPU). ``MAGGY_TPU_WORKER_DEVICES="0,1"``
    leases those cards, so several worker processes can share a host.

    Returns None or a zero-argument CALLABLE that resolves to the device
    list: the worker touches no card before it has registered with the
    driver. Whatever needs no card is checked now: a typo fails at start-up,
    not after the worker was handed a trial (which would strand it until
    worker_timeout, and loop forever under --respawn). With
    ``config.device="cpu"`` the lease resolves to the CPU."""
    spec = os.environ.get("MAGGY_TPU_WORKER_DEVICES", "").strip()
    if not spec:
        return None
    try:
        idxs = [int(i) for i in spec.split(",")]
    except ValueError as e:
        raise RuntimeError(
            f"MAGGY_TPU_WORKER_DEVICES={spec!r} is not a comma-separated "
            f"list of local device indices: {e}"
        ) from e
    if len(set(idxs)) != len(idxs) or any(i < 0 for i in idxs):
        raise RuntimeError(
            f"MAGGY_TPU_WORKER_DEVICES={spec!r} must name distinct "
            "non-negative indices — duplicate or negative leases would "
            "silently alias devices instead of a disjoint sub-slice"
        )
    cpu = getattr(config, "device", None) is not None and str(config.device).startswith("cpu")

    def resolve():
        import torch

        if cpu:
            return [torch.device("cpu")]
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to the config to run trials on the CPU"
            )
        n = torch.cuda.device_count()
        if any(i >= n for i in idxs):
            raise RuntimeError(f"MAGGY_TPU_WORKER_DEVICES={spec!r} indexes past this host's {n} local device(s)")
        return [torch.device("cuda", i) for i in idxs]

    return resolve


def run_trial_worker(
    train_fn: Callable, config, host: str, port: int, secret: str, via_registry: bool = False,
) -> Any:
    """Run this process as one remote TRIAL executor of an HPO or ablation
    experiment: any host running the same script with
    ``MAGGY_TPU_ROLE=worker`` adds trial capacity. Loops {register → GET →
    trial → FINAL} until the driver answers GSTOP."""
    from maggy_tpu_torch.core.driver.base import device_groups
    from maggy_tpu_torch.core.executors.trial import trial_executor_fn
    from maggy_tpu_torch.exceptions import RpcError

    pid = partition_id()
    lease = _worker_devices(config)
    if lease is None:
        # this host's first lease (checked now: no CUDA and no device raises)
        lease = device_groups(getattr(config, "devices_per_trial", 1), getattr(config, "device", None))[0]
    app_id, run_id = _bootstrap_ids(host, port, pid, secret, via_registry)
    resolve = None
    study = getattr(config, "ablation_study", None)
    if study is not None:
        # the worker holds the same AblationConfig the driver does, so the
        # variant resolver is rebuilt here
        from maggy_tpu_torch.core.driver.ablation import make_ablation_resolver

        resolve = make_ablation_resolver(study)
    executor = trial_executor_fn(
        train_fn=train_fn,
        config=config,
        app_id=app_id,
        run_id=run_id,
        partition_id=pid,
        server_addr=(host, port),
        secret=secret,
        devices=lease,
        resolve=resolve,
    )
    try:
        executor()
    except RpcError as e:
        # the driver is unreachable mid-loop. Normal completion is not this
        # path (the driver answers GSTOP before its server goes), so the
        # process exits nonzero and a supervisor (--respawn) can put the
        # capacity back
        import sys

        print(
            f"[maggy_tpu_torch pod worker {pid}] driver unreachable ({e}); exiting "
            "for the supervisor to respawn",
            file=sys.stderr,
        )
        raise
    return {"role": "trial_worker", "partition_id": pid}
