"""Uniform random search (reference optimizer/randomsearch.py:23-113).

Pre-samples ``num_trials`` de-duplicated configurations at initialization; with a
pruner attached, configurations are drawn on demand with the pruner's budgets
(promoted trials re-use their original params, reference randomsearch.py:47-90).
"""

from __future__ import annotations

import logging
from typing import Optional, Union

from maggy_tpu_torch.optimizer.abstractoptimizer import IDLE, AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class RandomSearch(AbstractOptimizer):
    def initialize(self) -> None:
        self._buffer = []
        if self.pruner is None:
            seen = set()
            attempts = 0
            # Oversample to dodge duplicate configs in small discrete spaces.
            while len(self._buffer) < self.num_trials and attempts < self.num_trials * 50:
                params = self.searchspace.sample(self._py_rng)
                tid = Trial.compute_id(params)
                if tid not in seen:
                    seen.add(tid)
                    self._buffer.append(params)
                attempts += 1
            if len(self._buffer) < self.num_trials:
                # Space has fewer unique configs than num_trials. Repeats would
                # collide in the id-keyed trial_store, so run what exists.
                logging.getLogger(__name__).warning(
                    "Searchspace holds only %d unique configurations; running %d "
                    "trials instead of the requested %d.",
                    len(self._buffer), len(self._buffer), self.num_trials,
                )

    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        if self.pruner is not None:
            return self._pruner_suggestion(trial)
        if self._buffer:
            return self.create_trial(self._buffer.pop(0), sample_type="random")
        return None

    def _pruner_suggestion(self, trial: Optional[Trial]) -> Union[Trial, str, None]:
        decision = self.pruner.pruning_routine()
        if decision == "IDLE":
            return IDLE
        if decision is None:
            return None

        def fresh():
            for _ in range(50):
                params = self.searchspace.sample(self._py_rng)
                if not self.hparams_exist(params):
                    return params, "random"
            return None, "random"

        return self.pruner_trial(decision, fresh)
