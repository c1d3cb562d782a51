"""Median stopping rule (reference earlystop/medianrule.py:27-60): stop a running
trial whose best observed metric is worse than the median of the finalized trials'
running averages evaluated at the same step."""

from __future__ import annotations

import statistics
from typing import Dict, List

from maggy_tpu_torch.earlystop.abstractearlystop import AbstractEarlyStop
from maggy_tpu_torch.trial import Trial


class MedianStoppingRule(AbstractEarlyStop):
    @staticmethod
    def earlystop_check(
        to_check: Dict[str, Trial], final_store: List[Trial], direction: str
    ) -> List[str]:
        stop_ids: List[str] = []
        if not final_store:
            return stop_ids
        for trial_id, trial in to_check.items():
            if not trial.step_history:
                continue
            step = trial.step_history[-1]
            avgs = [
                avg
                for avg in (t.running_avg(up_to_step=step) for t in final_store)
                if avg is not None
            ]
            if not avgs:
                continue
            median = statistics.median(avgs)
            metrics = trial.metrics
            if direction == "max":
                if max(metrics) < median:
                    stop_ids.append(trial_id)
            else:
                if min(metrics) > median:
                    stop_ids.append(trial_id)
        return stop_ids
