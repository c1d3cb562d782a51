"""No-op early-stopping policy (reference earlystop/nostop.py:20-25)."""

from __future__ import annotations

from typing import Dict, List

from maggy_tpu_torch.earlystop.abstractearlystop import AbstractEarlyStop
from maggy_tpu_torch.trial import Trial


class NoStoppingRule(AbstractEarlyStop):
    @staticmethod
    def earlystop_check(
        to_check: Dict[str, Trial], final_store: List[Trial], direction: str
    ) -> List[str]:
        return []
