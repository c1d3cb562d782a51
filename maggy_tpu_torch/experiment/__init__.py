"""Experiment front door: ``experiment.lagom(train_fn, config)``; the port's
copy of :mod:`maggy_tpu.experiment`.

Parity with the reference's lagom dispatch (experiment/experiment.py:21-45,
experiment_python.py:48-197): a single-experiment-at-a-time guard, app/run-id
bookkeeping, and driver selection by singledispatch on the config type. Trials
run in local executor threads, each on its lease of CUDA cards (or the CPU
with ``device="cpu"``). Single runs, HPO, ablation and distributed training
(one spawned process per card, each an NCCL rank on a mesh) are ported, and
so is pod mode (:mod:`maggy_tpu_torch.core.pod`): every process runs the
same script, process 0 drives and the others join it as ranks or trial
workers.

"Lagom" (Swedish): not too little, not too much — the reference's name for
running experiments with just the right amount of resources.
"""

from __future__ import annotations

import threading
from functools import singledispatch
from typing import Any, Callable, Optional

from maggy_tpu_torch import util
from maggy_tpu_torch.config import (
    AblationConfig,
    BaseConfig,
    DistributedConfig,
    HyperparameterOptConfig,
    LagomConfig,
)

APP_ID: Optional[str] = None
RUN_ID: int = 0
_running_lock = threading.Lock()
_running = False
_env_run_id_used = False
# the driver currently executing (monitoring/launcher introspection)
CURRENT_DRIVER = None


def lagom(train_fn: Callable, config: LagomConfig) -> Any:
    """Launch an experiment and block until its result is available.

    :param train_fn: the oblivious training function.
    :param config: a LagomConfig subclass instance selecting the experiment kind.
    :returns: experiment result — best/worst/avg dict for HPO and ablation, the train_fn
        outputs for single runs, per-worker results for distributed training.
    """
    global APP_ID, RUN_ID, _running
    if isinstance(train_fn, LagomConfig) and callable(config):
        raise TypeError(
            "lagom(train_fn, config): arguments look swapped — got a config "
            "first and a callable second."
        )
    if not callable(train_fn):
        raise TypeError(f"train_fn must be callable, got {type(train_fn).__name__}")
    with _running_lock:
        if _running:
            raise RuntimeError(
                "An experiment is already running; maggy runs one experiment "
                "at a time (reference experiment_pyspark.py:43-64 guard)."
            )
        _running = True
    try:
        worker_result = _maybe_run_as_pod_worker(train_fn, config)
        if worker_result is not None:
            return worker_result
        import os

        global _env_run_id_used
        if APP_ID is None:
            # the elastic launcher pins app/run ids so every restart
            # generation shares one experiment dir (and its checkpoints)
            APP_ID = os.environ.get("MAGGY_TPU_APP_ID") or util.new_app_id()
        run_id_env = os.environ.get("MAGGY_TPU_RUN_ID")
        if run_id_env and not _env_run_id_used:
            # the pin applies to the process's FIRST experiment only; later
            # lagom() calls in the same script get fresh run dirs after it
            _env_run_id_used = True
            RUN_ID = int(run_id_env)
            util.RUNS.observe(APP_ID, RUN_ID)
        else:
            RUN_ID = util.RUNS.next_run_id(APP_ID)
        driver = lagom_driver(config, APP_ID, RUN_ID)
        global CURRENT_DRIVER
        CURRENT_DRIVER = driver
        try:
            return driver.run_experiment(train_fn)
        finally:
            CURRENT_DRIVER = None
    finally:
        with _running_lock:
            _running = False


# the JAX package's other config kinds, by class name (the port has no such
# classes yet), and the ROADMAP item that ports each
_NOT_PORTED = {
    "TuneConfig": "ROADMAP queue 1 item 9 (tooling)",
}


@singledispatch
def lagom_driver(config, app_id: str, run_id: int):
    item = _NOT_PORTED.get(type(config).__name__)
    if item is not None:
        raise NotImplementedError(f"{type(config).__name__} experiments are {item}, not ported yet")
    raise TypeError(
        f"Unsupported config type {type(config).__name__}; expected a "
        "LagomConfig subclass (BaseConfig, HyperparameterOptConfig, AblationConfig, DistributedConfig)."
    )


@lagom_driver.register(BaseConfig)
def _(config: BaseConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.hpo import BaseDriver

    return BaseDriver(config, app_id, run_id)


@lagom_driver.register(HyperparameterOptConfig)
def _(config: HyperparameterOptConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.hpo import HyperparameterOptDriver

    return HyperparameterOptDriver(config, app_id, run_id)


@lagom_driver.register(AblationConfig)
def _(config: AblationConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.ablation import AblationDriver

    return AblationDriver(config, app_id, run_id)


@lagom_driver.register(DistributedConfig)
def _(config: DistributedConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.distributed import DistributedTrainingDriver

    return DistributedTrainingDriver(config, app_id, run_id)


def _maybe_run_as_pod_worker(train_fn: Callable, config) -> Optional[Any]:
    """Pod mode: the processes other than the driver's run a worker against
    it instead of a driver of their own (core/pod.py). DistributedConfig
    workers are ranks of the training run; HPO/ablation workers run a
    remote TRIAL executor loop — the reference's Spark-executor trial
    placement (spark_driver.py:136-145), elastic here: workers may join
    late, die, and re-register (``maggy_tpu_torch.run --respawn``) without
    aborting the study."""
    import os

    distributed = isinstance(config, DistributedConfig)
    if not distributed and not (
        os.environ.get("MAGGY_TPU_ROLE") == "worker"
        or getattr(config, "driver_addr", None)
        or os.environ.get("MAGGY_TPU_DRIVER")
    ):
        return None
    from maggy_tpu_torch.core import pod

    role = pod.worker_role(config)
    if role is None:
        return None
    run = pod.run_worker if distributed else pod.run_trial_worker
    return run(train_fn, config, role.host, role.port, role.secret, via_registry=role.via_registry)
