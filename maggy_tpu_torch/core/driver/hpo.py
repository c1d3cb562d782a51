"""Hyperparameter-optimization driver — the HPO orchestrator; the port's copy
of :mod:`maggy_tpu.core.driver.hpo` without pod mode (ROADMAP queue 1 item 7f).

Capability parity with the reference ``HyperparameterOptDriver``
(core/experiment_driver/optimization_driver.py:40-692): optimizer/early-stop
wiring, executor cap at min(executors, trials), message callbacks for
REG (lost-trial detection on re-registration), METRIC (early-stop sweep),
FINAL (finalize → persist → next suggestion → assign or idle or done), periodic
idle-assignment retries, and best/worst/avg result aggregation persisted to
``result.json``.

``BaseDriver`` (reference base_driver.py:35-258) reuses the same machinery with a
SingleRun optimizer and one executor, returning the train_fn's outputs directly.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Any, Callable, Dict, List

from maggy_tpu_torch import constants, util
from maggy_tpu_torch.config.base import BaseConfig
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.driver.base import Driver, device_groups, driver_address
from maggy_tpu_torch.core.executors.trial import trial_executor_fn
from maggy_tpu_torch.optimizer import IDLE, get_earlystop, get_optimizer
from maggy_tpu_torch.optimizer.gridsearch import GridSearch
from maggy_tpu_torch.resilience import QuarantineTracker, RetryPolicy
from maggy_tpu_torch.trial import Trial


class HyperparameterOptDriver(Driver):
    def __init__(self, config, app_id: str, run_id: int):
        # leases first, before any directory, recorder or thread exists: with
        # no CUDA and no device this raises
        groups = device_groups(config.devices_per_trial, config.device)
        super().__init__(config, app_id, run_id)
        self.searchspace = config.searchspace
        self.direction = config.direction
        self.optimization_key = config.optimization_key

        self.trial_store: Dict[str, Trial] = {}
        self.final_store: List[Trial] = []
        # STATUS monitors tail recent controller decisions from memory
        from collections import deque

        self._controller_tail = deque(maxlen=40)

        # pruner (optional) — wired before the optimizer so it can override
        # num_trials (reference optimization_driver.py:88-89)
        self.pruner = self._make_pruner(config)
        num_trials = config.num_trials
        if self.pruner is not None:
            num_trials = self.pruner.num_trials()
        if isinstance(config.optimizer, str) and config.optimizer.lower() in (
            "gridsearch",
            "grid",
        ):
            num_trials = GridSearch.get_num_trials(config.searchspace)
        self.num_trials = num_trials

        # resume: preload a previous run's finalized trials so the controller
        # observes them and the driver never re-schedules them (§5.4 upgrade
        # over the reference, which cannot resume experiments)
        if getattr(config, "resume_from", None):
            from maggy_tpu_torch.train.checkpoint import load_finalized_trials

            for trial in load_finalized_trials(config.resume_from):
                self.final_store.append(trial)

        self.controller = get_optimizer(config.optimizer, seed=config.seed)
        self.controller.setup(
            config.searchspace,
            self.num_trials,
            self.trial_store,
            self.final_store,
            direction=config.direction,
            pruner=self.pruner,
        )
        self.earlystop = get_earlystop(config.es_policy)
        self._es_last_check = time.time()
        self._optimizer_exhausted = False
        self._maybe_idle: set = set()

        # resilience (docs/resilience.md): trials lost to TRANSIENT failures
        # (worker death / RPC loss) are requeued with a per-trial retry budget
        # and jittered exponential backoff instead of terminal ERROR; a worker
        # whose consecutive trials keep dying is quarantined out of
        # _try_assign for a cooldown. All state below is digestion-thread
        # owned (reads under self.lock where the STATUS path also looks).
        self.retry_policy = RetryPolicy.from_config(config)
        self.quarantine = QuarantineTracker(
            threshold=getattr(config, "quarantine_after", 3),
            cooldown=getattr(config, "quarantine_cooldown", 300.0),
        )
        self._retry_queue: List[tuple] = []  # (ready_ts, Trial), unordered
        self._stashed_suggestion = None  # probe result awaiting a worker

        # pod mode (remote hosts running the same script add trial capacity,
        # the reference's Spark executors, spark_driver.py:136-145) is not
        # ported
        if driver_address(config):
            raise NotImplementedError(
                "pod mode (driver_addr / MAGGY_TPU_DRIVER) is ROADMAP queue 1 item 7f "
                "(pod mode and elasticity), not ported yet"
            )

        self.num_executors = max(
            1, min(config.num_executors or len(groups), self.num_trials)
        )

    def _exp_startup_callback(self) -> None:
        # HParams plugin experiment config (reference tensorboard.py:47-102):
        # written once per experiment so the TB dashboard gets typed columns
        from maggy_tpu_torch import tensorboard as tb

        if len(self.config.searchspace):
            tb.write_hparams_config(self.exp_dir, self.config.searchspace)

    def _make_pruner(self, config):
        if config.pruner is None:
            return None
        if isinstance(config.pruner, str):
            if config.pruner.lower() == "hyperband":
                try:
                    from maggy_tpu_torch.pruner.hyperband import Hyperband
                except ImportError as e:
                    raise NotImplementedError(
                        f"The hyperband pruner requires the pruner module: {e}"
                    ) from e
                pruner_config = dict(config.pruner_config)
                pruner_config.setdefault("direction", config.direction)
                return Hyperband(
                    trial_metric_getter=self._trial_metric_getter, **pruner_config
                )
            raise ValueError(f"Unknown pruner {config.pruner!r}")
        return config.pruner

    def _trial_metric_getter(self, trial_ids):
        """Lookup final metrics by trial id for the pruner (reference pruner
        callbacks)."""
        if isinstance(trial_ids, str):
            trial_ids = [trial_ids]
        out = {}
        with self.lock:
            for t in self.final_store:
                if t.trial_id in trial_ids:
                    out[t.trial_id] = t.final_metric
        return out

    # ------------------------------------------------------------------ server

    def _make_server(self) -> rpc.Server:
        # a launcher may distribute one secret via env; otherwise the Server
        # mints a fresh one
        return rpc.Server(
            self.num_executors, secret=os.environ.get("MAGGY_TPU_SECRET") or None
        )

    def _register_msg_callbacks(self) -> None:
        s = self.server
        s.register_callback("REG", self._reg_callback)
        s.register_callback("QUERY", lambda m: {"type": "QUERY", "ready": s.reservations.done()})
        s.register_callback("GET", self._get_callback)
        s.register_callback("METRIC", self._metric_callback)
        s.register_callback("FINAL", self._final_callback)
        s.register_callback("LOG", self._log_callback)

    # --- event-loop handlers: fast, lock briefly, enqueue heavy work ----------

    def _reg_callback(self, msg) -> Dict[str, Any]:
        reregistered = self.server.reservations.register(
            msg["partition_id"], msg.get("meta", {})
        )
        self.server.enqueue({**msg, "reregistered": reregistered})
        return {"type": "OK"}

    def _get_callback(self, msg) -> Dict[str, Any]:
        pid = msg["partition_id"]
        assignment = self.server.reservations.get_assignment(pid)
        if assignment is not None:
            with self.lock:
                trial = self.trial_store.get(assignment)
            if trial is not None:
                return {"type": "TRIAL", "trial_id": trial.trial_id, "params": trial.params}
        if self.experiment_done.is_set() or self.abort.is_set():
            return {"type": "GSTOP"}
        return {"type": "IDLE"}

    def _metric_callback(self, msg) -> Dict[str, Any]:
        self.note_worker_telemetry(msg)
        self.server.enqueue(msg)
        if self.abort.is_set():
            # interrupt every broadcasting train_fn so aborted experiments do not
            # leave workers training on leased devices
            return {"type": "STOP"}
        trial_id = msg.get("trial_id")
        if trial_id:
            with self.lock:
                trial = self.trial_store.get(trial_id)
            if trial is not None and trial.get_early_stop():
                return {"type": "STOP"}
        return {"type": "OK"}

    def _final_callback(self, msg) -> Dict[str, Any]:
        # unassign synchronously (event loop), before the reply: the worker's
        # next GET must never see its finished trial still assigned, or it
        # would run it twice (reference clears in the socket thread too,
        # rpc.py:463-471)
        self.server.reservations.assign_trial(msg["partition_id"], None)
        self.server.enqueue(msg)
        return {"type": "OK"}

    def _log_callback(self, msg) -> Dict[str, Any]:
        return {"type": "LOG", "logs": self.drain_logs(), "progress": self.progress()}

    # ------------------------------------------------ digestion-thread handlers

    def _handle_message(self, msg: Dict[str, Any]) -> None:
        verb = msg.get("type")
        if verb == "REG":
            self._digest_reg(msg)
        elif verb == "METRIC":
            self._digest_metric(msg)
        elif verb == "FINAL":
            self._digest_final(msg)
        elif verb == "_WORKER_LOST":
            self._digest_worker_lost(msg)

    def _on_worker_death(self, partition_id: int, exc: BaseException) -> bool:
        """A local executor thread died. TRANSIENT failures (worker kill /
        RPC loss) are absorbed: the in-flight trial is requeued and the
        worker slot respawned on the digestion thread. Deterministic
        failures keep the fail-fast abort."""
        from maggy_tpu_torch.resilience import TRANSIENT, classify_failure

        if self.experiment_done.is_set() or classify_failure(exc) != TRANSIENT:
            return False
        self.telemetry.count("resilience.worker_deaths")
        self.server.enqueue(
            {
                "type": "_WORKER_LOST",
                "partition_id": partition_id,
                "error": f"{type(exc).__name__}: {exc}",
            }
        )
        return True

    def _digest_worker_lost(self, msg) -> None:
        pid = msg["partition_id"]
        self.log(f"Executor {pid} died ({msg['error']}); recovering")
        self._lose_assignment(pid, f"executor {pid} died: {msg['error']}")
        self._maybe_idle.discard(pid)
        # respawn the lost capacity — unless the slot is quarantined, in
        # which case it stays down for the cooldown
        if pid in getattr(self, "_local_pids", ()) and not self.quarantine.is_quarantined(pid):
            self._respawn_executor(pid)
        self._maybe_finish()

    def _digest_reg(self, msg) -> None:
        pid = msg["partition_id"]
        if msg.get("reregistered"):
            # worker restarted: its in-flight trial is lost
            # (reference rpc.py:415-437 -> optimization_driver.py:473-483)
            self._lose_assignment(pid, f"executor {pid} re-registered")
        self._try_assign(pid)

    def _lose_assignment(self, pid: int, reason: str) -> None:
        """Free ``pid``'s in-flight trial after a TRANSIENT loss (worker
        death / re-registration / RPC silence — the only paths that reach
        here; a train_fn exception arrives as a FINAL error instead and
        fails fast). The trial is requeued with backoff while its retry
        budget lasts; only an exhausted budget marks ERROR. Digestion thread
        only (controller-adjacent state)."""
        assignment = self.server.reservations.get_assignment(pid)
        if assignment is None:
            return
        with self.lock:
            lost = self.trial_store.pop(assignment, None)
        self.server.reservations.assign_trial(pid, None)
        if lost is None:
            return
        if self.quarantine.record_failure(pid):
            self.telemetry.count("resilience.workers_quarantined")
            self.log(
                f"Executor {pid} quarantined: {self.quarantine.threshold} "
                f"consecutive trials died on it (cooldown "
                f"{self.quarantine.cooldown:.0f}s)"
            )
        retries = int(lost.info_dict.get("retries", 0))
        if retries < self.retry_policy.max_retries:
            delay = self.retry_policy.delay(retries)
            lost.reset_for_retry()
            lost.info_dict["retries"] = retries + 1
            with self.lock:
                self._retry_queue.append((time.time() + delay, lost))
            self.telemetry.count("resilience.trials_requeued")
            self.log(
                f"Trial {assignment} lost ({reason}); requeued — retry "
                f"{retries + 1}/{self.retry_policy.max_retries} in {delay:.1f}s"
            )
        else:
            lost.error()
            with self.lock:
                self.final_store.append(lost)
            self._persist_trial(lost)
            self.telemetry.count("resilience.trials_exhausted")
            self.log(
                f"Trial {assignment} lost ({reason}); retry budget "
                f"({self.retry_policy.max_retries}) exhausted — marked ERROR"
            )
            self._maybe_finish()

    def _digest_metric(self, msg) -> None:
        trial_id, metric, step = msg.get("trial_id"), msg.get("metric"), msg.get("step")
        logs = msg.get("logs") or []
        if logs:
            self.add_executor_logs(logs)
        if trial_id and metric is not None:
            with self.lock:
                trial = self.trial_store.get(trial_id)
            if trial is not None:
                if trial.status != Trial.RUNNING:
                    trial.begin()
                trial.append_metric(metric, step if step is not None and step >= 0 else None)
        self._earlystop_sweep()

    def _earlystop_sweep(self) -> None:
        """Reference optimization_driver.py:433-471: run the early-stop policy
        every es_interval seconds once es_min trials have finalized."""
        cfg = self.config
        if time.time() - self._es_last_check < cfg.es_interval:
            return
        self._es_last_check = time.time()
        with self.lock:
            if len(self.final_store) < cfg.es_min:
                return
            to_check = {
                tid: t for tid, t in self.trial_store.items() if t.metric_history
            }
            final = list(self.final_store)
        for tid in self.earlystop.earlystop_check(to_check, final, self.direction):
            with self.lock:
                trial = self.trial_store.get(tid)
            if trial is not None and not trial.get_early_stop():
                trial.set_early_stop()
                self.log(f"Early stopping trial {tid}")

    def _digest_final(self, msg) -> None:
        pid = msg["partition_id"]
        trial_id = msg["trial_id"]
        with self.lock:
            trial = self.trial_store.pop(trial_id, None)
        if trial is None:
            # duplicate FINAL: the worker is healthy and unassigned —
            # reschedule it, or it idles forever
            self._try_assign(pid)
            return
        if msg.get("error"):
            trial.error()
            self.log(f"Trial {trial_id} errored: {msg['error']}")
            with self.lock:
                had_success = any(t.status == Trial.FINALIZED for t in self.final_store)
            if not had_success:
                # fail fast when nothing has ever succeeded — a broken train_fn
                # should not burn the whole trial budget
                raise RuntimeError(
                    f"First trial(s) failed with: {msg['error']} — aborting experiment."
                )
        else:
            trial.finalize(msg.get("metric"))
            trial.info_dict["outputs"] = msg.get("outputs") or {}
            if msg.get("early_stopped"):
                trial.info_dict["early_stopped"] = True
        with self.lock:
            self.final_store.append(trial)
        self._persist_trial(trial)
        # any completed trial (even an errored one — the WORKER survived to
        # report it) clears the worker's death streak
        self.quarantine.record_success(pid)
        # reservation already cleared synchronously by _final_callback
        self.log(
            f"Trial {trial_id} {trial.status} metric={trial.final_metric} "
            f"({len(self.final_store)} done)"
        )
        self._try_assign(pid)

    def _on_tick(self) -> None:
        # retry partitions that previously got IDLE (reference
        # optimization_driver.py:542-568 debounced retries) — these also pick
        # up requeued trials whose backoff has elapsed
        for pid in list(self._maybe_idle):
            self._try_assign(pid)
        self._maybe_finish()

    def _try_assign(self, pid: int) -> None:
        # THREADING INVARIANT: the controller
        # (optimizer/pruner) is single-threaded state — every
        # controller.get_suggestion call happens HERE, and _try_assign runs
        # only on the digestion thread (_handle_message/_on_tick). Event-loop
        # callbacks may read trial_store under self.lock but must never call
        # into the controller; keep it that way when adding verbs.
        if self.experiment_done.is_set():
            return
        if self.server.reservations.get_assignment(pid) is not None:
            return
        if self.quarantine.is_quarantined(pid):
            # no work for a quarantined worker; keep it on the tick radar so
            # it gets reconsidered once the cooldown releases it
            self._maybe_idle.add(pid)
            return
        # requeued trials outrank fresh suggestions: their budget is already
        # spent and the controller has observed nothing for them yet
        now = time.time()
        retry = None
        with self.lock:
            for i, (ready_ts, trial) in enumerate(self._retry_queue):
                if ready_ts <= now:
                    retry = self._retry_queue.pop(i)[1]
                    break
        if retry is not None:
            self._assign(pid, retry, note="retry")
            return
        with self.lock:
            finished = self.final_store[-1] if self.final_store else None
            done_ids = {t.trial_id for t in self.final_store}
            stash, self._stashed_suggestion = self._stashed_suggestion, None
        if stash is not None and stash.trial_id not in done_ids:
            self._assign(pid, stash)
            return
        suggestion = self.controller.get_suggestion(finished)
        # resumed experiments: skip suggestions that already finalized in the
        # previous run (bounded — each skip consumes the controller's budget)
        skips = 0
        while isinstance(suggestion, Trial) and suggestion.trial_id in done_ids:
            skips += 1
            if skips > self.num_trials + 1:
                suggestion = None
                break
            suggestion = self.controller.get_suggestion(None)
        if isinstance(suggestion, Trial):
            self._assign(pid, suggestion)
        elif suggestion == IDLE:
            self._maybe_idle.add(pid)
        else:  # None: optimizer exhausted
            self._optimizer_exhausted = True
            with self.lock:
                pending = len(self._retry_queue)
            if pending:
                # a requeued trial still needs this worker once its backoff
                # elapses — keep it on the tick radar
                self._maybe_idle.add(pid)
            else:
                self._maybe_idle.discard(pid)
            self._maybe_finish()

    def _assign(self, pid: int, trial: Trial, note: str = "") -> None:
        """Hand ``trial`` to executor ``pid`` (digestion thread only)."""
        trial.schedule(pid)
        with self.lock:
            self.trial_store[trial.trial_id] = trial
        self.server.reservations.assign_trial(pid, trial.trial_id)
        self._maybe_idle.discard(pid)
        kind = note or trial.info_dict.get("sample_type", "?")
        self._controller_log(
            f"{kind} trial {trial.trial_id} -> executor {pid} "
            f"budget={trial.params.get('budget')}"
        )

    def _maybe_finish(self) -> None:
        """Complete the experiment when no more work can or will be
        scheduled. Fixes the stranded-completion edge: the last worker dying
        *before* budget exhaustion used to leave nobody to poll the
        controller, hanging ``_await_completion`` forever — with nothing in
        flight and nothing queued, probe the controller directly; a Trial it
        returns is stashed for the next ``_try_assign``. Digestion thread
        only (calls into the controller)."""
        if self.experiment_done.is_set():
            return
        with self.lock:
            in_flight = len(self.trial_store)
            pending = len(self._retry_queue)
            stash = self._stashed_suggestion
            finished = self.final_store[-1] if self.final_store else None
        if in_flight or pending or stash is not None:
            return
        if not self._optimizer_exhausted:
            suggestion = self.controller.get_suggestion(finished)
            if isinstance(suggestion, Trial):
                with self.lock:
                    self._stashed_suggestion = suggestion
                return
            if suggestion == IDLE:
                # nothing in flight yet the controller is waiting — transient
                # (e.g. a pruner mid-decision); probe again next tick
                return
            self._optimizer_exhausted = True
        self._finish_experiment()

    def _finish_experiment(self) -> None:
        self._update_result()
        self.experiment_done.set()

    # ------------------------------------------------------------------ results

    def _ranked_done(self) -> List[Trial]:
        """Finalized metric-bearing trials, best first (single source of the
        ranking for both result.json and the live STATUS dashboard).
        Call under self.lock."""
        done = [t for t in self.final_store if t.final_metric is not None]
        return sorted(
            done, key=lambda t: t.final_metric, reverse=self.direction == "max"
        )

    def _update_result(self) -> None:
        with self.lock:
            ranked = self._ranked_done()
            errors = [t for t in self.final_store if t.status == Trial.ERROR]
            stopped = [t for t in self.final_store if t.info_dict.get("early_stopped")]
        if not ranked:
            self.result = {"num_trials": len(self.final_store), "best": None}
            return
        done = ranked
        best, worst = ranked[0], ranked[-1]
        self.result = {
            "best": {
                "trial_id": best.trial_id,
                "params": best.params,
                self.optimization_key: best.final_metric,
                "outputs": best.info_dict.get("outputs", {}),
            },
            "worst": {
                "trial_id": worst.trial_id,
                "params": worst.params,
                self.optimization_key: worst.final_metric,
            },
            "avg": statistics.mean(t.final_metric for t in done),
            "num_trials": len(self.final_store),
            "early_stopped": len(stopped),
            "errors": len(errors),
            "duration": time.time() - self.job_start if self.job_start else None,
        }

    def _persist_trial(self, trial: Trial) -> None:
        try:
            d = self.env.trial_dir(self.app_id, self.run_id, trial.trial_id)
            self.env.dump(trial.to_dict(), os.path.join(d, constants.TRIAL_FILE))
        except OSError as e:
            self.log(f"Could not persist trial {trial.trial_id}: {e}")

    def _exp_final_callback(self) -> None:
        self._update_result()
        try:
            self.env.dump(
                util._jsonify(self.result),
                os.path.join(self.exp_dir, constants.RESULT_FILE),
            )
            self.env.dump(
                {
                    "name": self.config.name,
                    "app_id": self.app_id,
                    "run_id": self.run_id,
                    "num_trials": self.num_trials,
                    "direction": self.direction,
                    "optimizer": self.controller.name(),
                    "duration": time.time() - self.job_start if self.job_start else None,
                },
                os.path.join(self.exp_dir, constants.EXPERIMENT_FILE),
            )
        except OSError as e:
            self.log(f"Could not persist experiment result: {e}")
        self.controller.finalize_experiment(self.final_store)

    def progress(self) -> str:
        with self.lock:
            return util.progress_bar(len(self.final_store), self.num_trials)

    def _controller_log(self, message: str) -> None:
        """Controller decision log (reference optimizer.log/pruner.log,
        abstractoptimizer.py:84-134 + abstractpruner.py:72-85). Also kept in a
        ring buffer so STATUS monitors can tail it without file access."""
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        with self.lock:
            self._controller_tail.append(line)
        try:
            with self.env.open_file(
                os.path.join(self.exp_dir, "optimizer.log"), "a"
            ) as f:
                f.write(line + "\n")
        except OSError:
            pass

    def _status(self):
        base = super()._status()
        with self.lock:
            ranked = self._ranked_done()
            best = None
            if ranked:
                best = {
                    "trial_id": ranked[0].trial_id,
                    "metric": ranked[0].final_metric,
                    "params": ranked[0].params,
                }
            base.update(
                controller=self.controller.name(),
                direction=self.direction,
                trials_done=len(self.final_store),
                trials_total=self.num_trials,
                trials_running=len(self.trial_store),
                early_stopped=sum(
                    1 for t in self.final_store
                    if t.info_dict.get("early_stopped")
                ),
                errors=sum(
                    1 for t in self.final_store if t.status == Trial.ERROR
                ),
                best=best,
                controller_log=list(self._controller_tail),
                trials_requeued=len(self._retry_queue),
            )
            quarantined = self.quarantine.snapshot()
            if quarantined:
                base.update(quarantined=quarantined)
        return base

    # ------------------------------------------------------------------ executor

    def _executor_fn(self, train_fn: Callable, partition_id: int, devices: list) -> Callable:
        return trial_executor_fn(
            train_fn=train_fn,
            config=self.config,
            app_id=self.app_id,
            run_id=self.run_id,
            partition_id=partition_id,
            server_addr=(self.server.host, self.server.port),
            secret=self.server.secret,
            devices=devices,
        )


class BaseDriver(HyperparameterOptDriver):
    """Single-run experiment (reference base_driver.py:35-258): run the train_fn
    once under full experiment bookkeeping and return its outputs."""

    def __init__(self, config: BaseConfig, app_id: str, run_id: int):
        from maggy_tpu_torch.config.hpo import HyperparameterOptConfig
        from maggy_tpu_torch.searchspace import Searchspace

        hpo_config = HyperparameterOptConfig(
            num_trials=1,
            optimizer="none",
            searchspace=Searchspace(),
            optimization_key="metric",
            es_policy="none",
            es_min=2**31,
            name=config.name,
            description=config.description,
            hb_interval=config.hb_interval,
            model=config.model,
            dataset=config.dataset,
            num_executors=1,
            log_dir=config.log_dir,
            device=config.device,
        )
        hpo_config.hparams = config.hparams
        super().__init__(hpo_config, app_id, run_id)

    def _exp_final_callback(self) -> None:
        super()._exp_final_callback()
        best = (self.result or {}).get("best") or {}
        outputs = best.get("outputs") or {}
        # return the train_fn's own outputs, like the reference BaseDriver
        # (base_driver.py:221-242)
        self.result = outputs if outputs else self.result
