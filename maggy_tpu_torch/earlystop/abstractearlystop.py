"""Early-stopping policy interface (reference earlystop/abstractearlystop.py:25)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List

from maggy_tpu_torch.trial import Trial


class AbstractEarlyStop(ABC):
    @staticmethod
    @abstractmethod
    def earlystop_check(
        to_check: Dict[str, Trial], final_store: List[Trial], direction: str
    ) -> List[str]:
        """Return trial ids among ``to_check`` (running trials) that should stop,
        judged against the finalized trials in ``final_store``."""
