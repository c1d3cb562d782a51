"""LOCO — Leave One Component Out; the port's copy of
:mod:`maggy_tpu.ablation.ablator.loco`.

Capability parity with the reference ``maggy/ablation/ablator/loco.py:26-261``:
trial 0 is the full-model baseline, then one trial per included feature, per
model component, per component group, and per custom model generator. Trial
params carry ``ablated_feature`` / ``ablated_component`` markers; the ablation
executor resolves them into concrete (dataset, model) pairs via the study's
generators, so the user's train_fn stays oblivious.
"""

from __future__ import annotations

from typing import List, Optional

from maggy_tpu_torch.ablation.ablator.abstractablator import AbstractAblator
from maggy_tpu_torch.trial import Trial


class LOCO(AbstractAblator):
    def __init__(self, ablation_study, final_store=None):
        super().__init__(ablation_study, final_store)
        self._buffer: List[Trial] = []

    def initialize(self) -> None:
        study = self.ablation_study
        trials = [self._make_trial(None, None)]  # baseline first
        for feature in study.features.list_all():
            trials.append(self._make_trial(feature, None))
        for comp in study.model.layers.included:
            trials.append(self._make_trial(None, comp))
        for group in study.model.layers.included_groups:
            trials.append(self._make_trial(None, "|".join(sorted(group))))
        for name in sorted(study.model.custom_generators):
            trials.append(self._make_trial(None, f"custom:{name}"))
        self._buffer = trials

    def get_number_of_trials(self) -> int:
        study = self.ablation_study
        return (
            1
            + len(study.features.list_all())
            + len(study.model.layers.included)
            + len(study.model.layers.included_groups)
            + len(study.model.custom_generators)
        )

    def get_trial(self, ablation_trial: Optional[Trial] = None) -> Optional[Trial]:
        return self._buffer.pop(0) if self._buffer else None

    @staticmethod
    def _make_trial(feature: Optional[str], component: Optional[str]) -> Trial:
        return Trial(
            {"ablated_feature": feature or "None", "ablated_component": component or "None"},
            trial_type="ablation",
        )
