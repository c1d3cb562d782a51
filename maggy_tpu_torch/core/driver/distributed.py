"""Distributed-training driver: the port's counterpart of
:mod:`maggy_tpu.core.driver.distributed`.

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

Elastic membership (``elastic=True``), as in JAX: epoch-numbered views of
the active slices, the ``SLICE_EVENT`` and ``MEMBERSHIP`` verbs, the
reshape barrier with its acks, the view in ``EXEC_CONFIG`` and the
heartbeat's ``RESHAPE`` reply, ``min_slices`` as a clean floor
(``MembershipViolation`` is the experiment's error) and the gauges and
counters of the JAX driver. A slice is a contiguous block of rank
processes:

* ``num_slices=N`` (mode ``"sim"``): the ``num_executors`` spawned ranks
  are N slices of one process group (``data_plane="auto"``). At each epoch
  the ranks of the active slices leave their group and form a new one at
  the new width, on a fresh rendezvous this driver hands out with the
  epoch's ``EXEC_CONFIG``; a dropped slice's ranks stay parked at the
  barrier until a view takes their slice back in, or until the run ends
  and releases them (their ``FINAL`` carries no result).
* ``num_slices=None`` (mode ``"workers"``): each rank is one slice. A rank
  that dies is a drop and charges no restart slot. Under
  ``data_plane="local"`` the survivors reshape in their processes; under
  ``data_plane="auto"`` a dead rank leaves its peers inside a collective,
  so the survivors are terminated and relaunched at the reduced width,
  resuming from the latest checkpoint (a deliberate divergence: JAX's
  survivors reshape in place).

``result["num_workers"]`` counts the ranks active at the end.
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
from maggy_tpu_torch.parallel.mesh import slice_device_groups

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
        # elastic membership (docs/resilience.md "Elastic membership"):
        # epoch-numbered views of the active slices; on a slice's loss or
        # return the mesh reshapes instead of relaunching at the same width
        self.elastic = bool(getattr(config, "elastic", False))
        self.membership = None
        self._member_acks: Dict[int, int] = {}  # partition -> last acked epoch
        self._reshape_t0 = 0.0  # perf_counter at the last epoch bump
        self._reshape_epoch_timed = -1  # epoch whose barrier was already gauged
        self._relaunching = False  # a workers-mode drop is queued to relaunch the survivors
        self._per_slice = 1  # ranks a slice
        if self.elastic:
            from maggy_tpu_torch.resilience.membership import MembershipView

            total = int(getattr(config, "num_slices", None) or self.num_executors)
            min_slices = int(getattr(config, "min_slices", 1))
            if min_slices > total:
                raise ValueError(f"min_slices={min_slices} exceeds the launch width ({total} slice(s))")
            self._per_slice = len(slice_device_groups(total, range(self.num_executors))[0])
            mode = "sim" if getattr(config, "num_slices", None) is not None else "workers"
            if mode == "sim" and (self.pod_mode or config.data_plane != "auto"):
                raise ValueError(
                    "num_slices lays slices out as blocks of the spawned ranks of one process group: it needs "
                    "data_plane='auto' and no driver_addr (num_slices=None makes each rank a slice of its own)"
                )
            if self.pod_mode and config.data_plane == "auto" and self.num_executors > 1:
                raise NotImplementedError(
                    "elastic membership over a launcher-formed pod group (driver_addr with data_plane='auto') is "
                    "ROADMAP queue 1 item 7f3, not ported yet; data_plane='local' runs it, each pod process a slice"
                )
            self.membership = MembershipView.full(total, min_slices, mode=mode)
            self.telemetry.gauge("resilience.membership_epoch", 0)
            self.telemetry.gauge("resilience.active_slices", total)

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
        if self.elastic:
            # the membership protocol: SLICE_EVENT reports a drop or rejoin
            # for digestion; MEMBERSHIP is the reshape barrier's poll, which
            # records the caller's acked epoch and says whether every
            # member has converged
            s.register_callback("SLICE_EVENT", self._slice_event_callback)
            s.register_callback("MEMBERSHIP", self._membership_callback)
        s.register_callback("GET", lambda m: {"type": "GSTOP"})
        s.register_callback("LOG", lambda m: {"type": "LOG", "logs": self.drain_logs(), "progress": ""})

    def _touch(self, pid: int) -> None:
        with self.lock:
            self._last_seen[pid] = time.time()

    def _reg_callback(self, msg) -> Dict[str, Any]:
        pid = msg["partition_id"]
        restarted = self.server.reservations.register(pid, msg.get("meta", {}))
        self._touch(pid)
        if restarted and self.elastic and self.membership.mode == "workers" and pid in self.membership.inactive:
            # a dropped slice's worker came back (a supervisor's respawn):
            # its rejoin epoch reshapes every survivor back to the wider mesh
            self.server.enqueue({"type": "_SLICE_EVENT", "kind": "rejoin", "slice": pid, "partition_id": pid})
        return {"type": "OK"}

    def _slice_partitions(self, slices) -> List[int]:
        """The partitions (ranks of the launch) of ``slices``, in slice order."""
        per = self._per_slice
        return [s * per + i for s in sorted(slices) for i in range(per)]

    def _exec_config_callback(self, msg) -> Dict[str, Any]:
        """The cluster layout: every spawned rank gets the same rendezvous
        (rank 0's host, a port free when the first rank asked) and its own
        rank; app/run ids ride along so pod workers land their files in
        the driver's experiment directory. The evaluator is outside the
        training group (reference: the TF evaluator is not in the
        TF_CONFIG worker list)."""
        pid = int(msg["partition_id"])
        view = self.membership
        with self.lock:
            # one rendezvous a generation of the group: a restart or a new
            # membership epoch forms the group anew on a fresh port
            key = (self._restart_epoch, view.epoch if view is not None else 0)
            if self._master is None or self._master[0] != key:
                fresh = self._master is not None or not self.config.coordinator_port
                self._master = (key, "127.0.0.1", _free_port() if fresh else int(self.config.coordinator_port))
            _, addr, port = self._master
        spec = self.server.reservations.cluster_spec()
        # advertised only on pods, where the launcher formed the group
        coordinator = os.environ.get("MAGGY_TPU_COORDINATOR") if self.pod_mode else None
        num_processes = self.num_executors - (1 if self.evaluator_partition is not None else 0)
        out = {
            "type": "EXEC_CONFIG",
            "num_processes": num_processes,
            "world_size": num_processes,
            "rank": pid,
            "master_addr": addr,
            "master_port": port,
            "coordinator": coordinator,
            "cluster": spec,
            "evaluator_partition": self.evaluator_partition,
            "app_id": self.app_id,
            "run_id": self.run_id,
        }
        if view is not None:
            # membership rides the config exchange: a reshape re-runs
            # EXEC_CONFIG, so the layout a rank builds is always the one the
            # current epoch's view describes; the group is the active
            # slices' ranks, each at its place among them
            ranks = self._slice_partitions(view.active)
            out.update(membership=view.as_dict(), ranks_per_slice=self._per_slice, num_processes=len(ranks),
                       world_size=len(ranks), rank=ranks.index(pid) if pid in ranks else None)
            self._ack(pid, view.epoch)
        return out

    def _metric_callback(self, msg) -> Dict[str, Any]:
        self._touch(msg["partition_id"])
        self.note_worker_telemetry(msg)
        self.server.enqueue(msg)
        if self.abort.is_set():
            return {"type": "STOP"}
        if self.elastic and msg.get("epoch") is not None:
            view = self.membership  # one read: digestion swaps whole views
            if int(msg["epoch"]) < view.epoch:
                # this rank runs a stale layout: its fit raises
                # MembershipChanged at the next step boundary
                return {"type": "RESHAPE", "epoch": view.epoch}
        return {"type": "OK"}

    # ------------------------------------------------------- membership verbs

    def _slice_event_callback(self, msg) -> Dict[str, Any]:
        """A rank observed a slice drop or rejoin: queued for digestion,
        which bumps the epoch and does the accounting."""
        self.server.enqueue({"type": "_SLICE_EVENT", "kind": msg.get("kind"), "slice": msg.get("slice"),
                             "partition_id": msg.get("partition_id"), "step": msg.get("step")})
        return {"type": "OK"}

    def _membership_callback(self, msg) -> Dict[str, Any]:
        """The reshape barrier's poll: record the caller's acked epoch;
        ready once every member has acked the current one. No member
        re-forms its group before all of them have left the old one, saved
        the step the transition asks for and agreed on the view. A parked
        rank is released once every active rank has sent its FINAL."""
        pid, acked = msg.get("partition_id"), msg.get("epoch")
        view = self.membership
        if pid is not None and acked is not None:
            self._ack(int(pid), int(acked))
        with self.lock:
            ready = self._converged(view)
            release = all(p in self._final_pids for p in self._slice_partitions(view.active))
        return {"type": "MEMBERSHIP", "view": view.as_dict(), "ready": ready, "release": release,
                "aborted": self.abort.is_set()}

    def _ack(self, pid: int, epoch: int) -> None:
        """Record ``pid``'s ack of ``epoch``; the first time every member
        has acked an epoch gauges ``resilience.reshape_ms``."""
        with self.lock:
            self._member_acks[pid] = max(epoch, self._member_acks.get(pid, -1))
            view = self.membership
            if self._converged(view) and view.epoch > 0 and self._reshape_epoch_timed < view.epoch:
                self._reshape_epoch_timed = view.epoch
                ms = (time.perf_counter() - self._reshape_t0) * 1e3
                self.telemetry.gauge("resilience.reshape_ms", ms)
                self.log(f"Membership epoch {view.epoch}: every member acked, reshape barrier complete {ms:.1f} ms "
                         "after the epoch bump")

    def _converged(self, view) -> bool:
        """Whether every barrier member acked ``view``'s epoch (call under
        ``self.lock``). The members are the ranks still running: every rank
        of a sliced group (a parked one acks from its park), the active
        slices' workers otherwise, less those that already sent a FINAL."""
        if view.mode == "sim":
            members = range(self.num_executors)
        else:
            members = [p for p in view.active if p < self.num_executors]
        return all(self._member_acks.get(p, -1) >= view.epoch for p in members if p not in self._final_pids)

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
        if self.elastic and self.membership.mode == "workers":
            return self._death_as_drop(partition_id, exc)
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

    def _death_as_drop(self, partition_id: int, exc: BaseException) -> bool:
        """Workers mode: the slice is the rank, so its death is a membership
        drop, and no restart slot is charged (a ``min_slices`` violation
        aborts from digestion). In one group of spawned ranks the drop also
        relaunches the survivors; the deaths it causes (the survivors
        reaped, a peer's lost collective) are absorbed with it."""
        with self.lock:
            if self._group_restarts:
                if (self._relaunching or getattr(exc, "peer_lost", False)
                        or partition_id not in self.membership.active):
                    return True
                self._relaunching = True
        self.telemetry.count("resilience.worker_deaths")
        self.server.enqueue({"type": "_SLICE_EVENT", "kind": "drop", "slice": partition_id,
                             "partition_id": partition_id, "error": f"{type(exc).__name__}: {exc}"})
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

    def _digest_slice_event(self, msg: Dict[str, Any]) -> None:
        """Apply a membership transition: bump the epoch, start the reshape
        clock, and let the heartbeat and the barrier carry the new view to
        every member. A ``min_slices`` violation aborts the run with the
        violation as the experiment's error, never a wait on a barrier that
        cannot complete. A workers-mode drop in one group of spawned ranks
        then relaunches the survivors at the new width."""
        from maggy_tpu_torch.resilience.membership import MembershipViolation

        kind, slice_id = msg.get("kind"), msg.get("slice")
        view = self.membership
        try:
            new = view.drop(slice_id) if kind == "drop" else view.rejoin(slice_id)
        except (MembershipViolation, ValueError) as e:
            self.log(f"Membership {kind} of slice {slice_id} rejected: {e}")
            with self.lock:
                if self.exception is None:
                    self.exception = e
                self._relaunching = False
            self.abort.set()
            self.experiment_done.set()
            return
        if new.epoch == view.epoch:
            self.log(f"Membership {kind} of slice {slice_id} ignored (duplicate report at epoch {view.epoch})")
            return
        with self.lock:
            self.membership = new
            self._reshape_t0 = time.perf_counter()
            if kind == "drop" and new.mode == "workers":  # the slice is that rank, gone
                self._last_seen.pop(slice_id, None)
        self.telemetry.count("resilience.slice_drops" if kind == "drop" else "resilience.slice_rejoins")
        self.telemetry.gauge("resilience.membership_epoch", new.epoch)
        self.telemetry.gauge("resilience.active_slices", new.n_active)
        self.log(
            f"Membership epoch {new.epoch}: slice {slice_id} {'left' if kind == 'drop' else 'rejoined'}"
            + (f" ({msg['error']})" if msg.get("error") else "")
            + f"; active slices {list(new.active)}/{new.total_slices}: reshape barrier open, the members "
            "converge on the latest complete checkpoint"
        )
        if self._relaunching and kind == "drop":
            self._relaunch_survivors(new)
        # a drop can complete the run at once: every remaining member may
        # already have sent its FINAL
        self._check_elastic_completion()

    def _relaunch_survivors(self, view) -> None:
        """Workers mode over one group of spawned ranks: the survivors wait
        inside collectives that lost a peer, so they are killed (no save)
        and relaunched at the reduced width on a fresh rendezvous; each
        resumes from the latest checkpoint. No restart slot is charged."""
        survivors = [p for p in view.active if p < self.num_executors]
        with self.lock:
            self._tearing_down = True
            for p in survivors:
                self._finals = [m for m in self._finals if m["partition_id"] != p]
                self._final_pids.discard(p)
                self._last_seen.pop(p, None)
        self.log(f"Slice drop in one process group: relaunching the survivors {survivors} at width {len(survivors)}")
        self._reap_ranks(kill=True)
        for t in list(self._worker_threads):
            t.join(timeout=TERMINATE_GRACE_S + 5)
        with self.lock:
            self._tearing_down = False
            self._relaunching = False
        for p in survivors:
            self._respawn_executor(p)

    def _needed_finals(self) -> int:
        if self.elastic and self.membership.mode == "workers":
            return self.membership.n_active
        return self.num_executors

    def _check_elastic_completion(self) -> None:
        with self.lock:
            done = len(self._finals)
        if done >= self._needed_finals() and not self.experiment_done.is_set():
            self._aggregate()
            self.experiment_done.set()

    def _handle_message(self, msg: Dict[str, Any]) -> None:
        verb = msg.get("type")
        if verb == "_RESTART":
            self._digest_restart(msg)
        elif verb == "_SLICE_EVENT":
            self._digest_slice_event(msg)
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
            needed = self._needed_finals()
            self.log(f"Worker {msg['partition_id']} finished ({done}/{needed})")
            if done >= needed:
                self._aggregate()
                self.experiment_done.set()

    def _aggregate(self) -> None:
        """Average the training ranks' numeric metric and outputs (the JAX
        driver's ``_aggregate``, reference
        torch_distributed_training_driver.py:49-69, 137-146). The
        evaluator's outputs are reported separately, never averaged into
        the training mean, and neither are the empty ones of parked ranks
        (slices inactive at the end)."""
        finals = self._finals
        if self.elastic:
            active = set(self._slice_partitions(self.membership.active))
            finals = [m for m in finals if m["partition_id"] in active]
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
            if self.elastic:
                view = self.membership
                base.update(
                    membership_epoch=view.epoch,
                    active_slices=list(view.active),
                    num_slices=view.total_slices,
                    min_slices=view.min_slices,
                    membership_mode=view.mode,
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
                restarting = (self._tearing_down or self._relaunching
                              or self._charged_epoch == self._restart_epoch)
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
            if self.elastic and self.membership.mode == "workers":
                # heartbeat-silent slices leave the membership: the mesh
                # reshapes around them (a min_slices violation aborts from
                # digestion), no restart slot is charged, and a later
                # registration rejoins them
                for pid in stale:
                    with self.lock:
                        self._last_seen.pop(pid, None)
                    self.telemetry.count("resilience.worker_deaths")
                    self.server.enqueue({"type": "_SLICE_EVENT", "kind": "drop", "slice": pid, "partition_id": pid,
                                         "error": f"silent > {timeout:.0f}s"})
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
