"""Parallel Hyperband pruner (BOHB-style).

Capability parity with the reference ``maggy/pruner/hyperband.py:29-594``:
geometric budget brackets, per-bracket successive-halving rungs, promotion of
the top 1/eta finishers, and an async ``pruning_routine`` that hands the
optimizer one decision at a time — fresh config at the base rung, promotion
into a higher rung, IDLE while promotions wait on stragglers, or None when the
whole schedule has been consumed. Unlike the reference's ``_top`` (which, like
ASHA's ``_top_k``, ignores direction), ranking here respects ``direction``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

from maggy_tpu_torch.pruner.abstractpruner import AbstractPruner


class _Rung:
    def __init__(self, budget: float, capacity: int):
        self.budget = budget
        self.capacity = capacity
        self.trials: List[str] = []  # new_trial_ids occupying this rung
        self.promoted_from: set = set()  # source trial ids already promoted here


class _Bracket:
    def __init__(self, s: int, s_max: int, eta: int, resource_max: float):
        self.rungs: List[_Rung] = []
        n0 = int(math.ceil((s_max + 1) / (s + 1) * eta**s))
        for k in range(s + 1):
            n_k = max(1, int(n0 // eta**k))
            budget = resource_max * float(eta) ** (k - s)
            self.rungs.append(_Rung(budget, n_k))


class Hyperband(AbstractPruner):
    def __init__(
        self,
        trial_metric_getter,
        eta: int = 3,
        resource_min: float = 1,
        resource_max: float = 9,
        direction: str = "max",
        iterations: int = 1,
    ):
        """:param iterations: how many full Hyperband cycles to schedule
        (hpbandster's ``n_iterations``; the reference runs SH iterations
        concurrently, hyperband.py:137-195). With one cycle, a fleet larger
        than the base rungs can sit IDLE behind straggler-gated promotions;
        extra cycles keep every executor busy — later cycles' base rungs
        stay eligible while earlier cycles wait on stragglers."""
        super().__init__(trial_metric_getter, direction)
        if eta < 2:
            raise ValueError("eta must be >= 2")
        if resource_min <= 0 or resource_max < resource_min:
            raise ValueError("need 0 < resource_min <= resource_max")
        if iterations < 1:
            raise ValueError("iterations must be >= 1")
        self.eta = int(eta)
        s_max = int(math.floor(math.log(resource_max / resource_min, eta) + 1e-9))
        self.brackets = [
            _Bracket(s, s_max, self.eta, resource_max)
            for _ in range(int(iterations))
            for s in range(s_max, -1, -1)
        ]
        self._pending = None  # (rung, source_trial_id) awaiting report_trial

    # ------------------------------------------------------------------ interface

    def num_trials(self) -> int:
        return sum(r.capacity for b in self.brackets for r in b.rungs)

    def pruning_routine(self) -> Union[Dict, str, None]:
        if self._pending is not None:
            # optimizer must report the previous decision before asking again
            return "IDLE"
        any_incomplete = False
        for bracket in self.brackets:
            for k, rung in enumerate(bracket.rungs):
                if len(rung.trials) >= rung.capacity:
                    continue
                any_incomplete = True
                if k == 0:
                    self._pending = (rung, None)
                    return {"trial_id": None, "budget": rung.budget}
                prev = bracket.rungs[k - 1]
                if len(prev.trials) < prev.capacity:
                    continue  # lower rung not fully scheduled yet
                # presence in the getter result == finalized; a None metric
                # (errored trial) still counts as finished, ranked worst, so a
                # failed trial can never deadlock the bracket
                worst = float("-inf") if self.direction == "max" else float("inf")
                finished = {
                    t: (m if m is not None else worst)
                    for t, m in self.trial_metric_getter(prev.trials).items()
                }
                if len(finished) < prev.capacity:
                    continue  # stragglers still running
                candidate = self._best_unpromoted(finished, rung)
                if candidate is None:
                    continue  # everything promotable already promoted
                self._pending = (rung, candidate)
                return {"trial_id": candidate, "budget": rung.budget}
        return "IDLE" if any_incomplete else None

    def report_trial(self, original_trial_id: Optional[str], new_trial_id: str) -> None:
        if self._pending is None:
            return
        rung, source = self._pending
        rung.trials.append(new_trial_id)
        if source is not None:
            rung.promoted_from.add(source)
        self._pending = None

    # ------------------------------------------------------------------ internals

    def _best_unpromoted(self, finished: Dict[str, float], rung: _Rung) -> Optional[str]:
        ranked = sorted(
            finished.items(), key=lambda kv: kv[1], reverse=self.direction == "max"
        )
        for trial_id, _ in ranked:
            if trial_id not in rung.promoted_from:
                return trial_id
        return None
