"""Trial executor — the worker-side loop for HPO, ablation and single-run
experiments; the port's copy of :mod:`maggy_tpu.core.executors.trial`.

Capability parity with the reference ``trial_executor_fn``
(core/executors/trial_executor.py:35-213): register → heartbeat → loop
{blocking get_suggestion → per-trial logdir + .hparams.json → signature-based
kwarg injection → train_fn → normalize return value → finalize_metric} until
GSTOP. Early stops arrive as EarlyStopException out of ``reporter.broadcast``
and keep the last metric (trial_executor.py:194-196).

Differences from the reference: the worker holds a lease on a disjoint group
of CUDA cards (or the CPU), passed as the ``devices`` kwarg, a list of
``torch.device``; train_fn errors are reported to the driver as errored
trials instead of killing a Spark task. Each executor is a thread and CUDA's
current device is per host thread, so the thread makes the lease's first card
current before its first trial, and again before an experiment kind's
``resolve`` hook builds the trial's model: a train_fn that builds
``Trainer(..., device="cuda")`` then lands on its own card. The hook and the
kwarg injection run inside the trial's error handling, so a variant that
cannot be built is that trial's error, not a dead worker.
"""

from __future__ import annotations

import inspect
import os
import socket as socket_mod
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from maggy_tpu_torch import constants, util
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.env import EnvSing
from maggy_tpu_torch.exceptions import EarlyStopException, WorkerLost
from maggy_tpu_torch.reporter import Reporter, capture_prints

# keys stripped from trial params before they reach the train_fn as hparams
# ("budget" stays available via the dedicated kwarg and in hparams for ASHA-style
# train_fns; "run"/"rep" are pure bookkeeping nonces)
_CONTROL_KEYS = ("run", "rep")


def trial_executor_fn(
    train_fn: Callable,
    config,
    app_id: str,
    run_id: int,
    partition_id: int,
    server_addr,
    secret: str,
    devices: Optional[List[torch.device]] = None,
    resolve: Optional[Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]] = None,
) -> Callable[[], None]:
    lease = list(devices or [])
    # one lease-wide TrainContext shared by every trial this worker runs,
    # built only if a train_fn asks for it
    _ctx_cache: Dict[str, Any] = {}

    def _lease_ctx():
        if "ctx" not in _ctx_cache:
            from maggy_tpu_torch.parallel.spec import ShardingSpec
            from maggy_tpu_torch.train.trainer import TrainContext

            # honor a sharding preset configured on the experiment (default
            # dp); a trial is a thread of the driver, so only the ring runs
            # inside its lease: a mesh spans one process per card
            preset = getattr(config, "sharding", None) or "dp"
            spec = ShardingSpec.preset(preset, len(lease)) if isinstance(preset, str) else preset
            if spec.sp == 1:
                raise NotImplementedError(
                    f"a trial's ctx over a mesh ({spec}) is ROADMAP queue 1 item 7h, not ported yet: "
                    "a mesh spans one process per card and trials run as threads; "
                    "lagom(train_fn, DistributedConfig(...)) runs a mesh"
                )
            _ctx_cache["ctx"] = TrainContext.local(spec, device=lease[0])
        return _ctx_cache["ctx"]

    def _make_current() -> None:
        if lease and lease[0].type == "cuda":
            torch.cuda.set_device(lease[0])

    def _executor() -> None:
        from maggy_tpu_torch import telemetry

        _make_current()
        env = EnvSing.get_instance()
        exp_dir = env.experiment_dir(app_id, run_id)
        log_file = os.path.join(exp_dir, f"executor_{partition_id}.log")
        reporter = Reporter(log_file=log_file, partition_id=partition_id)
        # per-worker recorder, ambient for this thread: Trainer.fit and the
        # Checkpointer inside the train_fn record into it; the heartbeat
        # attaches snapshots and flushes it to the JSONL sink every beat
        tel = telemetry.worker_telemetry(partition_id, exp_dir, role="trial", env=env)
        telemetry.set_current(tel)
        client = rpc.Client(
            server_addr, partition_id, secret, hb_interval=config.hb_interval,
            telemetry=tel,
        )
        try:
            client.register(
                meta={
                    "host": socket_mod.gethostname(),
                    "devices": [str(d) for d in lease],
                }
            )
            client.start_heartbeat(reporter)
            while True:
                reply = client.get_suggestion()
                if reply["type"] == "GSTOP":
                    break
                _run_trial(reply, client, reporter, env)
        finally:
            client.stop()
            reporter.close()
            telemetry.set_current(None)
            tel.close()

    def _run_trial(reply: Dict[str, Any], client: rpc.Client, reporter: Reporter, env) -> None:
        from maggy_tpu_torch import tensorboard as tb

        trial_id, params = reply["trial_id"], dict(reply["params"])
        reporter.reset(trial_id)
        trial_dir = env.trial_dir(app_id, run_id, trial_id)
        tb._register(trial_dir)  # registry only; persistence is the line below
        try:
            env.dump(util._jsonify(params), os.path.join(trial_dir, constants.HPARAMS_FILE))
        except OSError:
            pass

        hparams = {
            **dict(getattr(config, "hparams", None) or {}),
            **{k: v for k, v in params.items() if k not in _CONTROL_KEYS},
        }
        fn_params = inspect.signature(train_fn).parameters
        available = {
            "hparams": hparams,
            "reporter": reporter,
            "model": getattr(config, "model", None),
            "dataset": getattr(config, "dataset", None),
            "devices": list(lease),
            "trial_dir": trial_dir,
            "budget": params.get("budget"),
        }

        from maggy_tpu_torch import telemetry

        tel = telemetry.get()
        metric: Optional[float] = None
        outputs: Dict[str, Any] = {}
        error: Optional[str] = None
        early = False
        try:
            if resolve is not None:
                # experiment-kind hook: ablation swaps in per-trial
                # model/dataset, building the model on the lease's card
                _make_current()
                available = resolve(params, available)
            if "ctx" in fn_params:
                # a preset the port lacks raises here: this trial's error
                available["ctx"] = _lease_ctx()
            kwargs = util.inject_kwargs(train_fn, available)
            # train_fn prints ship to the driver with the heartbeat logs
            # (reference trial_executor.py:93-103)
            with tel.span("trial", trial_id=trial_id), capture_prints(reporter):
                retval = train_fn(**kwargs)
            metric = util.handle_return_val(
                retval, trial_dir, config.optimization_key
            )
            outputs = retval if isinstance(retval, dict) else {config.optimization_key: metric}
        except EarlyStopException as e:
            early = True
            metric = e.metric if e.metric is not None else reporter.get_metric()
            outputs = {config.optimization_key: metric}
            reporter.log(f"Trial {trial_id} early-stopped at metric {metric}")
        except WorkerLost:
            # worker death (preemption / chaos kill), not a trial error: no
            # FINAL goes out — the executor dies with it and the driver
            # requeues the in-flight trial and respawns/quarantines the slot
            tb._unregister()
            raise
        except Exception as e:  # noqa: BLE001 - errored trial, not a dead worker
            error = f"{type(e).__name__}: {e}"
            reporter.log(f"Trial {trial_id} failed:\n{traceback.format_exc()}")

        tb._unregister()
        tel.count("trials_errored" if error else "trials_done")
        tel.flush()  # trial boundary: events are durable before FINAL ships
        client.finalize_metric(
            trial_id,
            metric,
            outputs=util._jsonify(outputs),
            error=error,
            early_stopped=early,
        )

    return _executor
