"""Experiment driver base class: the port's copy of
:mod:`maggy_tpu.core.driver.base`.

Template-method orchestration with the same shape as the reference's Spark/Python
drivers (core/experiment_driver/spark_driver.py:39-287, python_driver.py:39-267):
``run_experiment`` = startup callback → init (RPC server + digestion thread) →
launch executors → await completion → final callback → stop.

Execution substrate: instead of Spark's ``foreachPartition`` long-running tasks
(spark_driver.py:136-145), executors are local worker threads, each leasing a
disjoint group of CUDA cards (trial ↔ card placement). Pod mode, where remote
hosts join over the same RPC protocol, is not ported (ROADMAP queue 1 item 7f).
"""

from __future__ import annotations

import atexit
import logging
import os
import queue
import threading
import time
import traceback
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional

import torch

from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.env import EnvSing

logger = logging.getLogger(__name__)


def device_groups(devices_per_trial: int = 1, device=None) -> List[List[torch.device]]:
    """Partition this host's CUDA cards into disjoint trial leases.

    The replacement for "1 Spark executor = 1 worker": a worker is a group
    of ``devices_per_trial`` cards, so N trials train concurrently on one
    host without contending for a card. The cards are
    ``range(torch.cuda.device_count())``, which already honours
    ``CUDA_VISIBLE_DEVICES``. ``device="cpu"`` gives the one lease
    ``[torch.device("cpu")]``. With no device named and no CUDA this raises:
    a lease never falls back to the CPU.
    """
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            return [[device]]
        if device.type != "cuda" or device.index is not None:
            raise ValueError(
                f"trials lease the CPU or all visible CUDA cards (narrow them with "
                f"CUDA_VISIBLE_DEVICES), got device={device}"
            )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to the config to run trials on the CPU"
        )
    k = max(1, devices_per_trial)
    n = torch.cuda.device_count()
    if n < k:
        raise ValueError(f"devices_per_trial={k} but only {n} CUDA card(s) are visible")
    return [[torch.device("cuda", g * k + i) for i in range(k)] for g in range(n // k)]


def driver_address(config) -> Optional[str]:
    """Pod-mode detection, copied from :func:`maggy_tpu.core.pod.driver_address`
    (the rest of ``core/pod.py`` is ROADMAP queue 1 item 7f)."""
    return os.environ.get("MAGGY_TPU_DRIVER") or getattr(config, "driver_addr", None)


class Driver(ABC):
    def __init__(self, config, app_id: str, run_id: int):
        self.config = config
        self.app_id = app_id
        self.run_id = run_id
        self.env = EnvSing.get_instance()
        self.exp_dir = config.log_dir or self.env.experiment_dir(app_id, run_id)
        self.num_executors: int = 1
        self.server: Optional[rpc.Server] = None
        self.result: Any = None
        self.executor_logs: List[str] = []
        self.exception: Optional[BaseException] = None
        self.lock = threading.RLock()
        self.abort = threading.Event()
        self.experiment_done = threading.Event()
        self._worker_threads: List[threading.Thread] = []
        self._digestion_thread: Optional[threading.Thread] = None
        self.job_start: Optional[float] = None
        self.duration: Optional[float] = None
        self._log_fd = None
        # telemetry: the driver's own recorder (server verb latencies land
        # here) plus the latest per-worker snapshot shipped on heartbeats —
        # folded into STATUS so monitors render a live throughput panel
        from maggy_tpu_torch import telemetry as _telemetry

        self.telemetry = _telemetry.worker_telemetry(
            "driver", self.exp_dir, role="driver", env=self.env
        )
        self.worker_telemetry: Dict[str, Any] = {}
        self._traces_exported = False

    # ------------------------------------------------------------------ hooks

    @abstractmethod
    def _make_server(self) -> rpc.Server:
        ...

    @abstractmethod
    def _register_msg_callbacks(self) -> None:
        ...

    @abstractmethod
    def _executor_fn(self, train_fn: Callable, partition_id: int, devices: list) -> Callable:
        """Return the zero-arg callable that runs one worker's loop."""

    def _exp_startup_callback(self) -> None:
        ...

    def _exp_final_callback(self) -> None:
        ...

    def _handle_message(self, msg: Dict[str, Any]) -> None:
        """Digestion-thread message handling; override per driver."""

    def _on_tick(self) -> None:
        """Digestion-thread periodic hook (assignment retries, early-stop sweeps)."""

    # ------------------------------------------------------------------ template

    def run_experiment(self, train_fn: Callable) -> Any:
        self.job_start = time.time()
        self._open_log()
        self.log(
            f"Starting experiment {self.config.name} "
            f"({type(self).__name__}, {self.num_executors} executors)"
        )
        # experiment state metadata: RUNNING -> FINISHED/FAILED, KILLED on
        # interpreter death (reference atexit/except hooks,
        # experiment_pyspark.py:149-183)
        self._write_state("RUNNING")
        atexit.register(self._kill_hook)
        try:
            self._exp_startup_callback()
            self.init()
            self._launch_executors(train_fn)
            self._await_completion()
            with self.lock:
                exc = self.exception
            if exc is not None:
                raise exc
            self._exp_final_callback()
            self.duration = time.time() - self.job_start
            self._write_state("FINISHED")
            return self.result
        except BaseException:
            self._write_state("FAILED")
            raise
        finally:
            atexit.unregister(self._kill_hook)
            self.stop()

    def _write_state(self, state: str) -> None:
        self._state = state
        try:
            self.env.dump(
                {
                    "state": state,
                    "name": self.config.name,
                    "app_id": self.app_id,
                    "run_id": self.run_id,
                    "ts": time.time(),
                },
                os.path.join(self.exp_dir, "state.json"),
            )
        except OSError:
            pass

    def _kill_hook(self) -> None:
        if getattr(self, "_state", None) == "RUNNING":
            self._write_state("KILLED")

    def note_worker_telemetry(self, msg: Dict[str, Any]) -> None:
        """Record a heartbeat's telemetry snapshot (event-loop thread; a
        single GIL-atomic dict store)."""
        snap = msg.get("telemetry")
        if snap:
            self.worker_telemetry[str(msg.get("partition_id"))] = snap

    def init(self) -> None:
        self.server = self._make_server()
        self.server.telemetry = self.telemetry
        self._register_msg_callbacks()
        # structured snapshot for monitors — registered for every driver kind
        # (the LOG verb ships lines; STATUS ships state — reference notebooks
        # only had the former)
        self.server.register_callback(
            "STATUS", lambda m: {"type": "STATUS", **self._status()}
        )
        # a launcher (python -m maggy_tpu.run in the JAX package) pre-assigns the port so workers
        # can be started with MAGGY_TPU_DRIVER before the driver is up
        self.server.start(port=int(os.environ.get("MAGGY_TPU_BIND_PORT", "0")))
        self._advertise()
        self._digestion_thread = threading.Thread(
            target=self._digest_loop, name="maggy-digestion", daemon=True
        )
        self._digestion_thread.start()

    def _advertise(self) -> None:
        """Write the driver-registry record (reference drivers register with
        Hopsworks REST, hopsworks.py:136-190): loopback with scope="local",
        which monitor auto-attach uses."""
        self._registered_driver = False
        # The registry record lives in the experiment root, so anyone who can
        # read that storage can join the control plane with the embedded
        # secret. On shared storage set MAGGY_TPU_REGISTRY_NO_SECRET=1 to
        # register address-only.
        omit_secret = os.environ.get("MAGGY_TPU_REGISTRY_NO_SECRET", "") not in ("", "0")
        try:
            self.env.register_driver(
                self.app_id, self.run_id, "127.0.0.1", self.server.port,
                secret=None if omit_secret else self.server.secret, scope="local",
            )
            self._registered_driver = True
        except OSError as e:  # the record is best-effort
            self.log(
                f"WARNING: could not write driver registry record "
                f"{self.env.driver_registry_path(self.app_id)}: {e}"
            )

    def _local_partitions(self) -> List[int]:
        """Partitions this process hosts (every one: pod mode, where remote
        hosts take some, is ROADMAP queue 1 item 7f)."""
        return list(range(self.num_executors))

    def _launch_executors(self, train_fn: Callable) -> None:
        # kept for elastic respawn (_respawn_executor): a replacement worker
        # for a dead slot needs the same train_fn/devices wiring
        self._train_fn = train_fn
        self._local_pids = set(self._local_partitions())
        groups = self._device_groups()
        for pid in self._local_partitions():
            devices = groups[pid % len(groups)]
            fn = self._executor_fn(train_fn, pid, devices)
            t = threading.Thread(
                target=self._worker_wrapper, args=(fn, pid),
                name=f"maggy-executor-{pid}", daemon=True,
            )
            self._worker_threads.append(t)
            t.start()

    def _respawn_executor(self, partition_id: int) -> None:
        """Relaunch one local executor slot after an absorbed worker death
        (digestion thread; see ``_on_worker_death``). The replacement builds
        a fresh RPC client — its new attempt nonce makes the re-REG read as
        a worker restart, which is exactly what it is."""
        groups = self._device_groups()
        devices = groups[partition_id % len(groups)]
        fn = self._executor_fn(self._train_fn, partition_id, devices)
        t = threading.Thread(
            target=self._worker_wrapper, args=(fn, partition_id),
            name=f"maggy-executor-{partition_id}-respawn", daemon=True,
        )
        self._worker_threads.append(t)
        t.start()
        self.log(f"Executor {partition_id} respawned")

    def _device_groups(self) -> List[list]:
        return device_groups(
            getattr(self.config, "devices_per_trial", 1), getattr(self.config, "device", None)
        )

    def _worker_wrapper(self, fn: Callable, partition_id: int) -> None:
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - unabsorbed death aborts the experiment
            if self._on_worker_death(partition_id, e):
                self.log(
                    f"Executor {partition_id} died ({type(e).__name__}: {e}); "
                    "absorbed by the resilience policy"
                )
                return
            with self.lock:
                if self.exception is None:
                    self.exception = e
            self.log(
                f"Executor {partition_id} died: {e}\n{traceback.format_exc()}"
            )
            self.abort.set()
            self.experiment_done.set()

    def _on_worker_death(self, partition_id: int, exc: BaseException) -> bool:
        """Hook for resilient drivers: return True when the death was
        absorbed (trial requeued / elastic restart queued) so the experiment
        continues; False (default) aborts it. Runs on the dying worker's
        thread — implementations must only enqueue work for the digestion
        thread, never touch controller state directly."""
        return False

    def _await_completion(self) -> None:
        for t in self._worker_threads:
            while t.is_alive():
                t.join(timeout=0.5)
                if self.abort.is_set():
                    # give workers a grace period to see GSTOP, then move on
                    t.join(timeout=5)
                    break

    def _digest_loop(self) -> None:
        while not self.experiment_done.is_set() or not self.server.message_queue.empty():
            try:
                msg = self.server.message_queue.get(timeout=0.1)
            except queue.Empty:
                msg = None
            try:
                if msg is not None:
                    self._handle_message(msg)
                self._on_tick()
            except BaseException as e:  # noqa: BLE001 - surfaced at finalization
                with self.lock:
                    if self.exception is None:
                        self.exception = e
                self.log(f"Driver digestion error: {e}\n{traceback.format_exc()}")
                self.abort.set()
                self.experiment_done.set()
                return

    def _export_telemetry(self) -> None:
        """Flush the driver recorder and assemble the merged Chrome trace +
        TensorBoard mirror from every worker's JSONL (local workers flushed
        theirs before FINAL; pod workers wrote to the shared root). Once per
        experiment, best-effort — observability must never fail a run."""
        if self._traces_exported:
            return
        self._traces_exported = True
        from maggy_tpu_torch import telemetry as _telemetry

        if not _telemetry.enabled():
            return
        try:
            self.telemetry.close()
            from maggy_tpu_torch.telemetry.export import (
                export_chrome_trace,
                mirror_to_tensorboard,
            )

            path = export_chrome_trace(self.env, self.exp_dir)
            if path:
                mirror_to_tensorboard(self.env, self.exp_dir)
                self.log(f"telemetry: merged Chrome trace at {path}")
        except Exception as e:  # noqa: BLE001 - exporters are best-effort
            logger.warning("telemetry export failed: %s", e)

    def stop(self) -> None:
        self.experiment_done.set()
        self._export_telemetry()
        if getattr(self, "_registered_driver", False):
            self.env.unregister_driver(self.app_id)
            self._registered_driver = False
        if self._digestion_thread is not None and self._digestion_thread.is_alive():
            self._digestion_thread.join(timeout=5)
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self._log_fd is not None:
            self._log_fd.close()
            self._log_fd = None
        if getattr(self, "_remote_log", False) and self._log_history:
            import posixpath

            try:
                self.env.dump(
                    "\n".join(self._log_history) + "\n",
                    posixpath.join(self.exp_dir, "maggy.log"),
                )
            except Exception:  # noqa: BLE001 - logs are best-effort
                pass
            self._log_history = []

    # ------------------------------------------------------------------ logging

    def _open_log(self) -> None:
        # remote roots: object stores can't append — buffer and publish once
        # at close() via the env seam (mirrors Reporter's executor logs)
        self._remote_log = "://" in str(self.exp_dir)
        self._log_history: List[str] = []
        if self._remote_log:
            self._log_fd = None
            return
        try:
            self._log_fd = open(os.path.join(self.exp_dir, "maggy.log"), "a", buffering=1)
        except OSError:
            self._log_fd = None

    def log(self, message: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        with self.lock:
            self.executor_logs.append(line)
            if self._log_fd is not None:
                self._log_fd.write(line + "\n")
            elif getattr(self, "_remote_log", False):
                self._log_history.append(line)
        logger.info(message)

    def add_executor_logs(self, logs: List[str]) -> None:
        with self.lock:
            self.executor_logs.extend(logs)

    def drain_logs(self) -> List[str]:
        with self.lock:
            out, self.executor_logs = self.executor_logs, []
            return out

    def progress(self) -> str:
        return ""

    def _status(self) -> Dict[str, Any]:
        """Structured snapshot for the STATUS verb; drivers extend it."""
        out = {
            "kind": type(self).__name__,
            "state": getattr(self, "_state", "UNKNOWN"),
            "name": self.config.name,
            "app_id": self.app_id,
            "run_id": self.run_id,
            "num_executors": self.num_executors,
            "elapsed_s": time.time() - self.job_start if self.job_start else None,
        }
        snaps = dict(self.worker_telemetry)  # event-loop-thread read; snapshot
        if self.telemetry.active:
            # the driver's own recorder rides along: resilience counters
            # (requeues, quarantines, restarts) live here, not on any worker
            drv = self.telemetry.snapshot()
            if drv.get("counters") or drv.get("gauges"):
                snaps = {**snaps, "driver": drv}
        if snaps:
            out["telemetry"] = snaps
        return out
