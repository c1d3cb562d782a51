"""Hyperparameter-optimization experiment config: the port's copy of
:mod:`maggy_tpu.config.hpo`.

Parity with the reference ``HyperparameterOptConfig``
(config/hyperparameter_optimization.py:33-93) minus the Spark-only guard — HPO runs
anywhere — plus scheduling knobs (``num_executors``, ``devices_per_trial``)
that replace Spark's executor count as the trial-parallelism control, and the
port's ``device``.
"""

from __future__ import annotations

from typing import Any, Optional, Union

from maggy_tpu_torch.config.base import LagomConfig
from maggy_tpu_torch.searchspace import Searchspace

DIRECTIONS = ("max", "min")


class HyperparameterOptConfig(LagomConfig):
    def __init__(
        self,
        num_trials: int,
        optimizer: Union[str, Any],
        searchspace: Searchspace,
        optimization_key: str = "metric",
        direction: str = "max",
        es_interval: int = 1,
        es_min: int = 10,
        es_policy: Union[str, Any] = "median",
        name: str = "HPOptimization",
        description: str = "",
        hb_interval: float = 1.0,
        model: Any = None,
        dataset: Any = None,
        num_executors: Optional[int] = None,
        devices_per_trial: int = 1,
        pruner: Optional[Union[str, Any]] = None,
        pruner_config: Optional[dict] = None,
        seed: Optional[int] = None,
        log_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
        sharding: Optional[Any] = None,
        driver_addr: Optional[str] = None,
        worker_timeout: float = 600.0,
        trial_retries: int = 2,
        retry_backoff: float = 0.5,
        quarantine_after: int = 3,
        quarantine_cooldown: float = 300.0,
        device: Optional[str] = None,
    ):
        """:param num_trials: total trials to run (pruner may override, as in the
            reference optimization_driver.py:88-93).
        :param optimizer: name in {"randomsearch","gridsearch","asha","tpe","gp","none"}
            or an AbstractOptimizer instance.
        :param searchspace: the Searchspace to explore.
        :param optimization_key: metric name used for ranking trials.
        :param direction: "max" or "min".
        :param es_interval: steps between early-stop checks.
        :param es_min: minimum finalized trials before early stopping activates.
        :param es_policy: "median", "none", or an AbstractEarlyStop instance.
        :param num_executors: trial workers to run concurrently; defaults to the
            number of leases (visible CUDA cards // devices_per_trial, or one
            on the CPU).
        :param devices_per_trial: devices leased to each trial (sub-slice size).
        :param pruner: optional "hyperband" or AbstractPruner instance.
        :param seed: RNG seed for samplers/surrogates.
        :param resume_from: path to a previous experiment directory; its
            finalized trials are preloaded and never re-run.
        :param sharding: the ``ctx`` injected into train_fns that ask for
            it: a ``ShardingSpec`` with ``sp > 1``, or ``"sp"`` (``sp`` = the
            lease's device count), gives a ``LocalRing`` of ``sp`` ranks on
            the lease's first device; the default "dp" and every other
            preset raise ``NotImplementedError`` when a train_fn asks for
            ``ctx``: a mesh spans one process per card, and trials are
            threads (a mesh inside a trial's lease is ROADMAP queue 1 item
            7h; ``lagom(train_fn, DistributedConfig(...))`` runs a mesh).
        :param driver_addr: pod mode, where remote trial workers connect
            (reference: Spark's cross-host executors, spark_driver.py:136-145).
            Not ported: setting it, or the MAGGY_TPU_DRIVER env var, raises
            ``NotImplementedError`` (ROADMAP queue 1 item 7f).
        :param worker_timeout: pod mode's liveness limit; kept so configs
            carry over, unused until pod mode is ported.
        :param trial_retries: how many times a trial lost to a TRANSIENT
            failure (worker death / RPC loss) is requeued before it is marked
            ERROR for good. Deterministic failures — an exception raised by
            the train_fn — never retry (docs/resilience.md). Env override:
            ``MAGGY_TPU_TRIAL_RETRIES``.
        :param retry_backoff: base seconds of the exponential (jittered)
            backoff before a requeued trial becomes schedulable again. Env
            override: ``MAGGY_TPU_RETRY_BACKOFF``.
        :param quarantine_after: consecutive lost trials after which a worker
            is quarantined out of scheduling (flaky host protection).
        :param quarantine_cooldown: seconds a quarantined worker sits out
            before re-entering on probation.
        :param device: ``None`` leases CUDA cards, ``devices_per_trial`` to a
            trial, and ``lagom`` raises before it launches anything when
            there is no CUDA; ``"cpu"`` gives every trial the lease
            ``[torch.device("cpu")]``.
        """
        super().__init__(name, description, hb_interval)
        if not isinstance(num_trials, int) or num_trials <= 0:
            raise ValueError("Number of trials should be greater than zero!")
        if not isinstance(searchspace, Searchspace):
            raise TypeError("searchspace must be a Searchspace instance")
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
        if devices_per_trial < 1:
            raise ValueError("devices_per_trial must be >= 1")
        self.num_trials = num_trials
        self.optimizer = optimizer
        self.searchspace = searchspace
        self.optimization_key = optimization_key
        self.direction = direction
        self.es_interval = int(es_interval)
        self.es_min = int(es_min)
        self.es_policy = es_policy
        self.model = model
        self.dataset = dataset
        self.num_executors = num_executors
        self.devices_per_trial = int(devices_per_trial)
        self.pruner = pruner
        self.pruner_config = dict(pruner_config or {})
        self.seed = seed
        self.log_dir = log_dir
        self.resume_from = resume_from
        self.sharding = sharding
        self.driver_addr = driver_addr
        self.worker_timeout = float(worker_timeout)
        if trial_retries < 0:
            raise ValueError("trial_retries must be >= 0")
        self.trial_retries = int(trial_retries)
        self.retry_backoff = float(retry_backoff)
        self.quarantine_after = int(quarantine_after)
        self.quarantine_cooldown = float(quarantine_cooldown)
        self.device = device
