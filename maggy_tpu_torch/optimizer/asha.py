"""ASHA — Asynchronous Successive Halving (arXiv:1810.05934).

Capability parity with the reference ``maggy/optimizer/asha.py:23-169``: geometric
budget rungs ``resource_min * reduction_factor**k``, promotion whenever
``len(finished_in_rung) // reduction_factor`` exceeds the number already promoted,
new random configurations at the base rung otherwise. Unlike the reference, whose
``_top_k`` always sorts descending regardless of ``direction`` (asha.py:166 — a
latent bug noted in SURVEY.md §2.6), promotion here respects the optimization
direction.

Budgets ride in ``trial.params["budget"]``; the train_fn reads it to size its
training (epochs/steps) — same contract as the reference (asha.py:130-152).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Union

from maggy_tpu_torch.optimizer.abstractoptimizer import IDLE, AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class Asha(AbstractOptimizer):
    def __init__(
        self,
        reduction_factor: int = 2,
        resource_min: float = 1,
        resource_max: float = 4,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2")
        if resource_min <= 0 or resource_max < resource_min:
            raise ValueError("need 0 < resource_min <= resource_max")
        self.reduction_factor = int(reduction_factor)
        self.resource_min = resource_min
        self.resource_max = resource_max

    def initialize(self) -> None:
        eta, r, R = self.reduction_factor, self.resource_min, self.resource_max
        # epsilon before floor: log(243, 3) == 4.999... would silently drop the
        # top rung otherwise
        self.num_rungs = int(math.floor(math.log(R / r, eta) + 1e-9)) + 1
        self.budgets = [min(r * eta**k, R) for k in range(self.num_rungs)]
        self._base_sampled = 0
        self._promoted: Dict[int, Set[str]] = {k: set() for k in range(self.num_rungs)}
        # config-id (params sans budget) of every created trial, for dedup
        self._seen_configs: Set[str] = set()

    # ------------------------------------------------------------------ helpers

    def _rung_of(self, trial: Trial) -> int:
        b = trial.params.get("budget", self.budgets[0])
        for k in reversed(range(self.num_rungs)):
            if b >= self.budgets[k]:
                return k
        return 0

    def _internal_metric(self, trial: Trial) -> float:
        # Metric-less trials (errored/early-stopped) sort worst in either direction.
        if trial.final_metric is None:
            return float("inf")
        m = trial.final_metric
        return -m if self.direction == "max" else m

    def _finished_in_rung(self, k: int) -> List[Trial]:
        return [t for t in self.final_store if self._rung_of(t) == k]

    def _config_id(self, trial: Trial) -> str:
        return Trial.compute_id(self._strip_budget(trial.params))

    # ------------------------------------------------------------------ interface

    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        # 1. promotion, top rung first, so trials climb as fast as possible
        for k in reversed(range(self.num_rungs - 1)):
            finished = self._finished_in_rung(k)
            quota = len(finished) // self.reduction_factor - len(self._promoted[k])
            if quota <= 0:
                continue
            candidates = sorted(finished, key=self._internal_metric)
            for cand in candidates:
                cid = self._config_id(cand)
                if cid in self._promoted[k]:
                    continue
                self._promoted[k].add(cid)
                new = self.create_trial(
                    self._strip_budget(cand.params),
                    budget=self.budgets[k + 1],
                    sample_type="promoted",
                    run_budget=self.budgets[k + 1],
                )
                return new

        # 2. fresh configuration at the base rung
        if self._base_sampled < self.num_trials:
            params = self.searchspace.sample(self._py_rng)
            attempts = 0
            while Trial.compute_id(params) in self._seen_configs and attempts < 100:
                params = self.searchspace.sample(self._py_rng)
                attempts += 1
            if Trial.compute_id(params) in self._seen_configs:
                # Space exhausted: a duplicate config would collide in the
                # id-keyed trial_store. Stop sampling the base rung.
                self._base_sampled = self.num_trials
                return self.get_suggestion(trial)
            self._seen_configs.add(Trial.compute_id(params))
            self._base_sampled += 1
            return self.create_trial(
                params,
                budget=self.budgets[0],
                sample_type="random",
                run_budget=self.budgets[0],
            )

        # 3. trials still in flight may unlock promotions when they land
        if self.trial_store:
            return IDLE

        return None
