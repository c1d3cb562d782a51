"""SingleRun: ``optimizer=None`` path — run num_trials empty-parameter trials
(reference optimizer/singlerun.py:21-37)."""

from __future__ import annotations

from typing import Optional, Union

from maggy_tpu_torch.optimizer.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class SingleRun(AbstractOptimizer):
    def initialize(self) -> None:
        self._remaining = self.num_trials

    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        if self._remaining <= 0:
            return None
        self._remaining -= 1
        # Distinct params per trial so trial ids do not collide.
        return self.create_trial(
            {"run": self.num_trials - self._remaining - 1}, sample_type="single"
        )
