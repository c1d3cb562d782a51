"""Ablator interface (reference ablation/ablator/abstractablator.py:20-86);
the port's copy of :mod:`maggy_tpu.ablation.ablator.abstractablator`."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from maggy_tpu_torch.trial import Trial


class AbstractAblator(ABC):
    def __init__(self, ablation_study, final_store=None):
        self.ablation_study = ablation_study
        self.final_store = final_store if final_store is not None else []

    @abstractmethod
    def get_number_of_trials(self) -> int:
        ...

    @abstractmethod
    def get_trial(self, ablation_trial: Optional[Trial] = None) -> Optional[Trial]:
        """Return the next ablation Trial or None when exhausted."""

    def initialize(self) -> None:
        ...

    def finalize_experiment(self, trials) -> None:
        ...
