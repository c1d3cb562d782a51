"""Optimizer (trial-generation controller) base class.

Capability parity with the reference ``maggy/optimizer/abstractoptimizer.py``
(abstractoptimizer.py:28-443): the driver polls ``get_suggestion`` after every
finalized trial; the optimizer reads the shared ``trial_store`` (busy trials) and
``final_store`` (finalized trials), supports a pruner hookup, budget-carrying
trials, duplicate-configuration checks, and metric accessors with max→min
negation so concrete algorithms can always minimize internally.
"""

from __future__ import annotations

import logging
import random
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Union

import numpy as np

from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial

logger = logging.getLogger(__name__)

# Sentinel returned by get_suggestion when no trial is available right now but the
# experiment is not finished (reference optimization_driver.py:542-568 IDLE path).
IDLE = "IDLE"


class AbstractOptimizer(ABC):
    def __init__(self, seed: Optional[int] = None, **kwargs):
        self.searchspace: Optional[Searchspace] = None
        self.num_trials: int = 0
        self.trial_store: Dict[str, Trial] = {}
        self.final_store: List[Trial] = []
        self.direction: str = "max"
        self.pruner = None
        self.rng = np.random.default_rng(seed)
        self._py_rng = random.Random(None if seed is None else int(seed))
        self.extra_config = kwargs

    # ------------------------------------------------------------- wiring
    # The driver injects shared state after construction
    # (reference optimization_driver.py:112-117).

    def setup(
        self,
        searchspace: Searchspace,
        num_trials: int,
        trial_store: Dict[str, Trial],
        final_store: List[Trial],
        direction: str = "max",
        pruner=None,
    ) -> None:
        self.searchspace = searchspace
        self.num_trials = num_trials
        self.trial_store = trial_store
        self.final_store = final_store
        self.direction = direction
        self.pruner = pruner
        self.initialize()

    # ------------------------------------------------------------- interface

    def initialize(self) -> None:
        """Hook run once after wiring; default no-op."""

    @abstractmethod
    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        """Return the next Trial, IDLE if the caller should retry later, or None
        when the experiment is exhausted. ``trial`` is the just-finalized trial,
        if any (reference abstractoptimizer.py:62)."""

    def finalize_experiment(self, trials: List[Trial]) -> None:
        """Hook run once when the experiment ends."""

    # ------------------------------------------------------------- trial creation

    def create_trial(
        self,
        params: Dict[str, Any],
        budget: Optional[float] = None,
        sample_type: str = "random",
        run_budget: Optional[float] = None,
    ) -> Trial:
        """Build a Trial, stamping budget into params and provenance into info_dict
        (reference abstractoptimizer.py:317-376)."""
        params = dict(params)
        if budget is not None:
            params["budget"] = budget
        info = {
            "sample_type": sample_type,
            "sampling_time": time.time(),
        }
        if run_budget is not None:
            info["run_budget"] = run_budget
        return Trial(params, trial_type="optimization", info_dict=info)

    # ------------------------------------------------------------- accessors

    # keys injected by the framework that are not hyperparameters
    CONTROL_KEYS = ("budget", "run", "rep")

    @classmethod
    def _strip_budget(cls, params: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in params.items() if k not in cls.CONTROL_KEYS}

    def _observed(self, budget: Optional[float] = None) -> List[Trial]:
        """Finalized trials with a usable metric, optionally at one budget rung.
        One filter for both accessors below, so X and y always align."""
        return [
            t
            for t in self.final_store
            if t.final_metric is not None
            and (budget is None or t.params.get("budget") == budget)
        ]

    def get_hparams_array(self, budget: Optional[float] = None) -> np.ndarray:
        """Design matrix of observed trials in the unit cube, optionally filtered
        to one budget rung (reference abstractoptimizer.py:186-252)."""
        return self.searchspace.transform_many(
            [self._strip_budget(t.params) for t in self._observed(budget)]
        )

    def get_metrics_array(self, budget: Optional[float] = None) -> np.ndarray:
        """Metrics of observed trials, negated under direction=max so the
        surrogate always minimizes (reference abstractoptimizer.py:186-252)."""
        vals = [
            -t.final_metric if self.direction == "max" else t.final_metric
            for t in self._observed(budget)
        ]
        return np.asarray(vals, dtype=np.float64)

    def hparams_exist(self, params: Dict[str, Any]) -> bool:
        """True if this configuration (budget ignored) has already been created
        (reference abstractoptimizer.py:254-295)."""
        target = Trial.compute_id(self._strip_budget(params))
        for t in self.trial_store.values():
            if Trial.compute_id(self._strip_budget(t.params)) == target:
                return True
        for t in self.final_store:
            if Trial.compute_id(self._strip_budget(t.params)) == target:
                return True
        return False

    def ybest(self, budget: Optional[float] = None) -> Optional[float]:
        y = self.get_metrics_array(budget)
        return float(y.min()) if y.size else None

    def yworst(self, budget: Optional[float] = None) -> Optional[float]:
        y = self.get_metrics_array(budget)
        return float(y.max()) if y.size else None

    def ymean(self, budget: Optional[float] = None) -> Optional[float]:
        y = self.get_metrics_array(budget)
        return float(y.mean()) if y.size else None

    def get_max_budget(self) -> Optional[float]:
        """Largest budget among known trials (reference abstractoptimizer.py:378-400)."""
        budgets = [
            t.params["budget"]
            for t in list(self.trial_store.values()) + self.final_store
            if "budget" in t.params
        ]
        return max(budgets) if budgets else None

    @property
    def num_created(self) -> int:
        return len(self.trial_store) + len(self.final_store)

    def name(self) -> str:
        return type(self).__name__

    # ------------------------------------------------------------- pruner protocol

    def _find_trial(self, trial_id: str) -> Trial:
        if trial_id in self.trial_store:
            return self.trial_store[trial_id]
        for t in self.final_store:
            if t.trial_id == trial_id:
                return t
        raise KeyError(f"Unknown trial id {trial_id}")

    def pruner_trial(self, decision: Dict[str, Any], fresh_sampler) -> Trial:
        """Turn a pruner decision into a Trial (shared by every pruner-capable
        optimizer). ``fresh_sampler() -> (params | None, sample_type)`` supplies
        fresh configs; on exhaustion the slot is filled by re-running a random
        config salted with a 'rep' nonce so trial ids never collide."""
        trial_id, budget = decision["trial_id"], decision["budget"]
        if trial_id is None:
            params, sample_type = fresh_sampler()
            if params is None:
                self._rep_counter = getattr(self, "_rep_counter", 0) + 1
                params = self.searchspace.sample(self._py_rng)
                params["rep"] = self._rep_counter
                sample_type = "repeat"
            new = self.create_trial(
                params, budget=budget, sample_type=sample_type, run_budget=budget
            )
        else:
            base = self._find_trial(trial_id)
            new = self.create_trial(
                self._strip_budget(base.params),
                budget=budget,
                sample_type="promoted",
                run_budget=budget,
            )
        self.pruner.report_trial(original_trial_id=trial_id, new_trial_id=new.trial_id)
        return new
