"""Distributed-training driver: the port's counterpart of
:mod:`maggy_tpu.core.driver.distributed`, without elastic membership
(ROADMAP queue 1 item 7f2).

One registration barrier, an ``EXEC_CONFIG`` exchange that tells every
rank the rendezvous (``MASTER_ADDR``, a free ``MASTER_PORT``, the world
size and its rank), per-rank final metrics averaged into the result. A
worker is one process on one card: partition *i* leases card *i*
(:func:`~maggy_tpu_torch.core.driver.base.device_groups`), or the CPU with
``device="cpu"``. A rank that fails, dies or outlives ``worker_timeout``
fails the run; on any abort every rank process is terminated, then killed,
and reaped.

As in JAX: pod mode (``driver_addr``/``MAGGY_TPU_DRIVER``: this process
runs partition 0 itself, the others join over RPC and go silent at their
peril, ``worker_timeout``), the evaluator (the last partition, outside the
training group, its outputs under ``result["evaluator"]``) and
``max_restarts`` (a rank lost to a TRANSIENT death is relaunched and
resumes from its latest checkpoint; a death report that an in-flight
restart already covers gets its slot refunded). Unlike JAX, whose restart
relaunches one executor thread spanning every device, a port rank lost
under ``data_plane="auto"`` with more than one rank leaves its peers
inside collectives that can never take a new peer: every rank is
terminated and the whole group relaunched, for one slot. Under
``data_plane="local"``, or with one rank, only the dead partition is.
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
        from maggy_tpu_torch.core.pod import driver_address

        # the leases first, before any directory, recorder or thread exists:
        # with no CUDA and no device this raises
        self._groups = device_groups(1, config.device)
        super().__init__(config, app_id, run_id)
        cpu = self._groups[0][0].type == "cpu"
        # pod mode: the other processes run their own copy of the script and
        # connect as workers (core/pod.py); this driver runs only partition 0
        self.pod_mode = bool(driver_address(config))
        self.num_executors = int(config.num_executors or (1 if cpu or self.pod_mode else len(self._groups)))
        if not cpu and not self.pod_mode and config.data_plane == "auto" and self.num_executors > len(self._groups):
            raise ValueError(
                f"num_executors={self.num_executors} ranks need as many CUDA cards, "
                f"{len(self._groups)} are visible"
            )
        # last worker becomes a dedicated evaluator (reference
        # tf_dist_executor.py:138-144); it shares the control plane but not
        # the training group
        self.evaluator_partition: Any = None
        if getattr(config, "evaluator", False):
            if self.num_executors < 2:
                raise ValueError(
                    "evaluator=True needs num_executors >= 2 (one training "
                    "worker plus the evaluator)"
                )
            if config.data_plane == "auto":
                # every port partition is a rank of the one group
                raise ValueError(
                    "evaluator=True requires data_plane='local': in a global "
                    "process group every process is part of the "
                    "training collective and none can be carved out."
                )
            self.evaluator_partition = self.num_executors - 1
        self._finals: List[Dict[str, Any]] = []
        self._final_pids: set = set()
        self._last_seen: Dict[int, float] = {}  # partition -> last contact ts
        self._master = None  # (addr, port) of the rendezvous, fixed at the first EXEC_CONFIG
        self._procs: Dict[int, Any] = {}  # partition -> its rank process
        self._procs_lock = threading.Lock()
        # restarts (docs/resilience.md): a TRANSIENT rank death consumes one
        # slot and relaunches the rank (under a live group of several ranks:
        # every rank); the replacement re-runs registration + EXEC_CONFIG
        # and its train_fn resumes from the latest checkpoint
        self.max_restarts = int(getattr(config, "max_restarts", 0))
        self._restarts = 0
        # every processed restart is one epoch: _RESTART messages carry the
        # epoch their death was observed at, and a partition restarts at most
        # once per epoch, so two reports of one loss never relaunch twice
        self._restart_epoch = 0
        self._restarted_at: Dict[int, int] = {}  # partition -> epoch of last restart
        self._charged_epoch = -1  # the epoch whose group restart is charged and queued
        self._tearing_down = False  # a group restart is reaping the old ranks

    @property
    def _group_restarts(self) -> bool:
        """Whether a lost rank takes the whole group with it: spawned ranks
        of one process group of more than one rank."""
        return not self.pod_mode and self.config.data_plane == "auto" and self.num_executors > 1

    # ------------------------------------------------------------------ server

    def _make_server(self) -> rpc.Server:
        # a launcher distributes one secret to every pod process via env
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
        """The cluster layout: every spawned rank gets the same rendezvous
        (rank 0's host, a port free when the first rank asked) and its own
        rank; app/run ids ride along so pod workers land their files in
        the driver's experiment directory. The evaluator is outside the
        training group (reference: the TF evaluator is not in the
        TF_CONFIG worker list)."""
        with self.lock:
            if self._master is None:
                self._master = ("127.0.0.1", int(self.config.coordinator_port or _free_port()))
            addr, port = self._master
        spec = self.server.reservations.cluster_spec()
        # advertised only on pods, where the launcher formed the group
        coordinator = os.environ.get("MAGGY_TPU_COORDINATOR") if self.pod_mode else None
        num_processes = self.num_executors - (1 if self.evaluator_partition is not None else 0)
        return {
            "type": "EXEC_CONFIG",
            "num_processes": num_processes,
            "world_size": num_processes,
            "rank": int(msg["partition_id"]),
            "master_addr": addr,
            "master_port": port,
            "coordinator": coordinator,
            "cluster": spec,
            "evaluator_partition": self.evaluator_partition,
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

    def _on_worker_death(self, partition_id: int, exc: BaseException) -> bool:
        """A rank's executor thread died: absorb TRANSIENT deaths while
        restart budget remains (runs on the dying thread — only enqueues).
        Under a group restart a death the restart already covers — the
        ranks it reaps, and a peer's report of the same loss — is absorbed
        without a charge."""
        from maggy_tpu_torch.resilience import TRANSIENT, classify_failure

        if self.experiment_done.is_set() or classify_failure(exc) != TRANSIENT:
            return False
        with self.lock:
            if self._group_restarts and (self._tearing_down or self._charged_epoch == self._restart_epoch):
                return True
            if self._restarts >= self.max_restarts:
                return False
            self._restarts += 1
            nth = self._restarts
            # serialize behind the restart epoch: the relaunch for THIS
            # death is valid only while no other restart of the same
            # partition lands first (double-fault window fix)
            observed_epoch = self._restart_epoch
            if self._group_restarts:
                self._charged_epoch = observed_epoch
        self.telemetry.count("resilience.dist_restarts")
        self.server.enqueue(
            {
                "type": "_RESTART",
                "partition_id": partition_id,
                "error": f"{type(exc).__name__}: {exc}",
                "restart": nth,
                "epoch": observed_epoch,
            }
        )
        return True

    def _digest_restart(self, msg: Dict[str, Any]) -> None:
        pid = msg["partition_id"]
        group = self._group_restarts
        with self.lock:
            # double-fault window: two reports of one loss, or a relaunch
            # already in flight for this partition. A restart observed
            # BEFORE the partition's last processed restart epoch is that
            # duplicate — refund the slot it charged and keep the one
            # relaunch instead of spawning a second executor for the
            # partition (which would double-FINAL and corrupt completion
            # accounting). A death observed at or after it is the relaunched
            # worker genuinely dying again and restarts normally.
            if self._restarted_at.get(pid, -1) > msg.get("epoch", 0):
                self._restarts = max(0, self._restarts - 1)
                self.log(
                    f"Worker {pid} death report superseded by an in-flight "
                    f"restart (epoch {self._restarted_at[pid]}); restart slot "
                    "refunded"
                )
                return
            self._restart_epoch += 1
            pids = list(range(self.num_executors)) if group else [pid]
            for p in pids:
                self._restarted_at[p] = self._restart_epoch
                # the partition's previous FINAL (if any) is void — its rerun
                # reports the authoritative one
                self._finals = [m for m in self._finals if m["partition_id"] != p]
                self._final_pids.discard(p)
                self._last_seen.pop(p, None)
            if group:
                self._tearing_down = True
        if group:
            self.log(
                f"Rank {pid} died ({msg['error']}); restart {msg['restart']}/{self.max_restarts}: "
                f"its peers wait inside collectives that cannot take a new rank, so every rank is "
                "killed and the group relaunched from the latest checkpoint"
            )
            # the generation is discarded: killed, with no preemption save
            self._reap_ranks(kill=True)
            for t in list(self._worker_threads):
                t.join(timeout=TERMINATE_GRACE_S + 5)
            with self.lock:
                self._master = None  # a fresh rendezvous: the old one died with rank 0
                self._tearing_down = False
            for p in pids:
                self._respawn_executor(p)
            return
        self.log(
            f"Worker {pid} died ({msg['error']}); elastic restart "
            f"{msg['restart']}/{self.max_restarts}: re-running registration "
            f"+ EXEC_CONFIG for partition {pid} and relaunching its train_fn "
            "from the latest checkpoint"
        )
        self._respawn_executor(pid)

    def _handle_message(self, msg: Dict[str, Any]) -> None:
        verb = msg.get("type")
        if verb == "_RESTART":
            self._digest_restart(msg)
        elif verb == "METRIC":
            logs = msg.get("logs") or []
            if logs:
                self.add_executor_logs(logs)
        elif verb == "FINAL":
            if msg.get("error"):
                raise RuntimeError(f"Distributed worker {msg['partition_id']} failed: {msg['error']}")
            with self.lock:
                # a restarted worker may FINAL twice for one partition —
                # keep only its latest result
                self._finals = [m for m in self._finals if m["partition_id"] != msg["partition_id"]]
                self._finals.append(msg)
                done = len(self._finals)
            self.log(f"Worker {msg['partition_id']} finished ({done}/{self.num_executors})")
            if done >= self.num_executors:
                self._aggregate()
                self.experiment_done.set()

    def _aggregate(self) -> None:
        """Average the training ranks' numeric metric and outputs (the JAX
        driver's ``_aggregate``, reference
        torch_distributed_training_driver.py:49-69, 137-146). The
        evaluator's outputs are reported separately, never averaged into
        the training mean."""
        finals = self._finals
        evaluator = None
        if self.evaluator_partition is not None:
            ev = [m for m in finals if m["partition_id"] == self.evaluator_partition]
            finals = [m for m in finals if m["partition_id"] != self.evaluator_partition]
            if ev:
                evaluator = ev[0].get("outputs") or {}
                if ev[0].get("metric") is not None:
                    evaluator.setdefault("metric", ev[0]["metric"])
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
        if evaluator is not None:
            result["evaluator"] = evaluator
        self.result = result

    def _status(self) -> Dict[str, Any]:
        base = super()._status()
        with self.lock:
            base.update(
                workers_done=len(self._final_pids),
                evaluator_partition=self.evaluator_partition,
                restarts=self._restarts,
                max_restarts=self.max_restarts,
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
        if not self.pod_mode:
            check_picklable(train_fn, self.config)  # before any process starts
        return super().run_experiment(train_fn)

    def _local_partitions(self) -> List[int]:
        if not self.pod_mode:
            return super()._local_partitions()
        self.log(
            f"Pod mode: driver at {socket.gethostname()}:{self.server.port} "
            f"(secret via MAGGY_TPU_SECRET), running local partition 0, "
            f"awaiting {self.num_executors - 1} remote workers"
        )
        return [0]

    def _device_groups(self) -> List[list]:
        # pod mode: this process's own card (executors.distributed._pod_device)
        return [[]] if self.pod_mode else self._groups

    def _spawned(self, partition_id: int, proc) -> None:
        with self._procs_lock:
            self._procs[partition_id] = proc
        if self.abort.is_set():  # spawned while the run was being aborted
            self._reap_ranks()

    def _reap_ranks(self, kill: bool = False) -> None:
        """Terminate every rank process still running, kill those that do
        not exit within ``TERMINATE_GRACE_S`` (a rank blocked in a wedged
        collective may never reach a signal handler), and reap them all.
        ``kill`` skips SIGTERM, whose handler would have ``fit`` save and
        report a FINAL."""
        with self._procs_lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.is_alive() and kill:
                p.kill()
            elif p.is_alive():
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
            if self.pod_mode:
                self._await_pod()
            else:
                self._await_local()
        finally:
            if self.abort.is_set() or self.exception is not None:
                self._reap_ranks()
            for t in list(self._worker_threads):
                t.join(timeout=TERMINATE_GRACE_S + 30)
            if not self.experiment_done.is_set() and self.exception is None:
                with self.lock:
                    self.exception = RuntimeError(
                        f"the ranks exited with {len(self._finals)} of {self.num_executors} finals"
                    )

    def _await_local(self) -> None:
        # wait for digestion to aggregate the finals. A dead rank may be
        # about to come back by a restart, so the grace clock only runs
        # while no executor thread is alive and no restart is being digested
        grace_deadline = None
        while not self.experiment_done.wait(timeout=0.2):
            if self.abort.is_set():
                return
            with self.lock:
                restarting = self._tearing_down or self._charged_epoch == self._restart_epoch
            if restarting or any(t.is_alive() for t in list(self._worker_threads)):
                grace_deadline = None
                continue
            if not self.server.message_queue.empty():
                continue  # a restart or FINAL still to digest
            if grace_deadline is None:
                grace_deadline = time.time() + 30
            elif time.time() > grace_deadline:
                return

    def _await_pod(self) -> None:
        # remote workers may train for hours: wait for every FINAL, but a
        # registered worker that goes silent past worker_timeout (its
        # heartbeat beats every hb_interval) fails the run loudly instead
        # of hanging the driver forever
        timeout = getattr(self.config, "worker_timeout", 1800.0)
        while not self.experiment_done.wait(timeout=1.0):
            if self.abort.is_set():
                return
            now = time.time()
            with self.lock:
                stale = [
                    pid for pid, ts in self._last_seen.items()
                    if now - ts > timeout and pid not in self._final_pids
                ]
            if not stale:
                continue
            with self.lock:
                budget_left = self.max_restarts - self._restarts
                if budget_left >= len(stale):
                    # restart window: charge the budget, forget the dead
                    # registrations, and keep waiting — the respawned
                    # processes (supervisor/launcher) re-register and resume
                    # from the latest checkpoint
                    self._restarts += len(stale)
                    for pid in stale:
                        self._last_seen.pop(pid, None)
                    restarts = self._restarts
                else:
                    restarts = None
            if restarts is not None:
                self.telemetry.count("resilience.dist_restarts", len(stale))
                self.log(
                    f"Pod worker(s) {stale} silent > {timeout:.0f}s; "
                    f"restart window open ({restarts}/{self.max_restarts} restarts used) "
                    "— awaiting re-registration"
                )
                continue
            with self.lock:
                if self.exception is None:
                    self.exception = RuntimeError(
                        f"Pod worker(s) {stale} silent for more than "
                        f"{timeout:.0f}s; aborting experiment."
                    )
            self.abort.set()
            self.experiment_done.set()
            return

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
            in_process=self.pod_mode,
        )
