"""Distributed-training driver: the port's counterpart of
:mod:`maggy_tpu.core.driver.distributed`, without pod mode, elastic
membership, restarts or the evaluator (ROADMAP queue 1 item 7f).

One registration barrier, an ``EXEC_CONFIG`` exchange that tells every
rank the rendezvous (``MASTER_ADDR``, a free ``MASTER_PORT``, the world
size and its rank), per-rank final metrics averaged into the result. A
worker is one process on one card: partition *i* leases card *i*
(:func:`~maggy_tpu_torch.core.driver.base.device_groups`), or the CPU with
``device="cpu"``. A rank that fails, dies or outlives ``worker_timeout``
fails the run; on any abort every rank process is terminated, then killed,
and reaped.
"""

from __future__ import annotations

import os
import socket
import statistics
import threading
import time
from typing import Any, Callable, Dict, List

from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.driver.base import Driver, device_groups
from maggy_tpu_torch.core.executors.distributed import check_picklable, dist_executor_fn

# seconds a rank gets to exit after SIGTERM before it is killed
TERMINATE_GRACE_S = 5.0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class DistributedTrainingDriver(Driver):
    def __init__(self, config, app_id: str, run_id: int):
        # the leases first, before any directory, recorder or thread exists:
        # with no CUDA and no device this raises
        self._groups = device_groups(1, config.device)
        super().__init__(config, app_id, run_id)
        cpu = self._groups[0][0].type == "cpu"
        self.num_executors = int(config.num_executors or (1 if cpu else len(self._groups)))
        if not cpu and self.num_executors > len(self._groups):
            raise ValueError(
                f"num_executors={self.num_executors} ranks need as many CUDA cards, "
                f"{len(self._groups)} are visible"
            )
        self._finals: List[Dict[str, Any]] = []
        self._final_pids: set = set()
        self._last_seen: Dict[int, float] = {}
        self._master = None  # (addr, port) of the rendezvous, fixed at the first EXEC_CONFIG
        self._procs: Dict[int, Any] = {}  # partition -> its rank process
        self._procs_lock = threading.Lock()

    # ------------------------------------------------------------------ server

    def _make_server(self) -> rpc.Server:
        return rpc.Server(self.num_executors, secret=os.environ.get("MAGGY_TPU_SECRET") or None)

    def _register_msg_callbacks(self) -> None:
        s = self.server
        s.register_callback("REG", self._reg_callback)
        s.register_callback("QUERY", lambda m: {"type": "QUERY", "ready": s.reservations.done()})
        s.register_callback("EXEC_CONFIG", self._exec_config_callback)
        s.register_callback(
            "RESERVATIONS", lambda m: {"type": "RESERVATIONS", "cluster": s.reservations.cluster_spec()}
        )
        s.register_callback("METRIC", self._metric_callback)
        s.register_callback("FINAL", self._final_callback)
        s.register_callback("GET", lambda m: {"type": "GSTOP"})
        s.register_callback("LOG", lambda m: {"type": "LOG", "logs": self.drain_logs(), "progress": ""})

    def _touch(self, pid: int) -> None:
        with self.lock:
            self._last_seen[pid] = time.time()

    def _reg_callback(self, msg) -> Dict[str, Any]:
        self.server.reservations.register(msg["partition_id"], msg.get("meta", {}))
        self._touch(msg["partition_id"])
        return {"type": "OK"}

    def _exec_config_callback(self, msg) -> Dict[str, Any]:
        """The cluster layout: every rank gets the same rendezvous (rank 0's
        host, a port free when the first rank asked) and its own rank."""
        with self.lock:
            if self._master is None:
                self._master = ("127.0.0.1", int(self.config.coordinator_port or _free_port()))
            addr, port = self._master
        return {
            "type": "EXEC_CONFIG",
            "num_processes": self.num_executors,
            "world_size": self.num_executors,
            "rank": int(msg["partition_id"]),
            "master_addr": addr,
            "master_port": port,
            "cluster": self.server.reservations.cluster_spec(),
            "app_id": self.app_id,
            "run_id": self.run_id,
        }

    def _metric_callback(self, msg) -> Dict[str, Any]:
        self._touch(msg["partition_id"])
        self.note_worker_telemetry(msg)
        self.server.enqueue(msg)
        if self.abort.is_set():
            return {"type": "STOP"}
        return {"type": "OK"}

    def _final_callback(self, msg) -> Dict[str, Any]:
        with self.lock:
            self._final_pids.add(msg["partition_id"])
        self._touch(msg["partition_id"])
        self.server.enqueue(msg)
        return {"type": "OK"}

    # ------------------------------------------------------------------ digestion

    def _handle_message(self, msg: Dict[str, Any]) -> None:
        verb = msg.get("type")
        if verb == "METRIC":
            logs = msg.get("logs") or []
            if logs:
                self.add_executor_logs(logs)
        elif verb == "FINAL":
            if msg.get("error"):
                raise RuntimeError(f"Distributed worker {msg['partition_id']} failed: {msg['error']}")
            with self.lock:
                self._finals = [m for m in self._finals if m["partition_id"] != msg["partition_id"]]
                self._finals.append(msg)
                done = len(self._finals)
            self.log(f"Worker {msg['partition_id']} finished ({done}/{self.num_executors})")
            if done >= self.num_executors:
                self._aggregate()
                self.experiment_done.set()

    def _aggregate(self) -> None:
        """Average the ranks' numeric metric and outputs (the JAX driver's
        ``_aggregate``, reference torch_distributed_training_driver.py)."""
        finals = self._finals
        outputs = [m.get("outputs") or {} for m in finals]
        metrics = [m.get("metric") for m in finals if m.get("metric") is not None]
        result: Dict[str, Any] = {"num_workers": len(finals)}
        if metrics:
            result["metric"] = statistics.mean(metrics)
        keys = set().union(*outputs) if outputs else set()
        for k in keys:
            vals = [o[k] for o in outputs if isinstance(o.get(k), (int, float))]
            if vals:
                result.setdefault("outputs", {})[k] = statistics.mean(vals)
        self.result = result

    def _status(self) -> Dict[str, Any]:
        base = super()._status()
        with self.lock:
            base.update(
                workers_done=len(self._final_pids),
                last_seen={str(pid): round(time.time() - ts, 1) for pid, ts in self._last_seen.items()},
            )
        return base

    def _exp_final_callback(self) -> None:
        if self.result and "outputs" in self.result:
            flat = dict(self.result["outputs"])
            flat.update({k: v for k, v in self.result.items() if k != "outputs"})
            self.result = flat

    # ------------------------------------------------------------------ ranks

    def run_experiment(self, train_fn: Callable) -> Any:
        check_picklable(train_fn, self.config)  # before any process starts
        return super().run_experiment(train_fn)

    def _device_groups(self) -> List[list]:
        return self._groups

    def _spawned(self, partition_id: int, proc) -> None:
        with self._procs_lock:
            self._procs[partition_id] = proc
        if self.abort.is_set():  # spawned while the run was being aborted
            self._reap_ranks()

    def _reap_ranks(self) -> None:
        """Terminate every rank process still running, kill those that do
        not exit within ``TERMINATE_GRACE_S``, and reap them all."""
        with self._procs_lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + TERMINATE_GRACE_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()

    def _await_completion(self) -> None:
        try:
            while not self.experiment_done.wait(timeout=0.2):
                if self.abort.is_set():
                    break
                if not any(t.is_alive() for t in self._worker_threads):
                    # every rank exited: the digestion thread aggregates their finals
                    self.experiment_done.wait(timeout=30)
                    break
        finally:
            if self.abort.is_set() or self.exception is not None:
                self._reap_ranks()
            for t in self._worker_threads:
                t.join(timeout=TERMINATE_GRACE_S + 30)
            if not self.experiment_done.is_set() and self.exception is None:
                with self.lock:
                    self.exception = RuntimeError(
                        f"the ranks exited with {len(self._finals)} of {self.num_executors} finals"
                    )

    def stop(self) -> None:
        self._reap_ranks()  # nothing outlives the run
        super().stop()

    def _executor_fn(self, train_fn: Callable, partition_id: int, devices: list) -> Callable:
        return dist_executor_fn(
            train_fn=train_fn,
            config=self.config,
            app_id=self.app_id,
            run_id=self.run_id,
            partition_id=partition_id,
            server_addr=(self.server.host, self.server.port),
            secret=self.server.secret,
            devices=devices,
            on_spawn=self._spawned,
        )
