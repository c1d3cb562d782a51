"""Pruner interface (reference pruner/abstractpruner.py:23-95).

A pruner owns the budget schedule; the optimizer only chooses *which* config
fills each slot. Contract with the optimizer (reference randomsearch.py:47-90,
bayes/base.py get_suggestion):

* ``pruning_routine()`` → ``{"trial_id": <id-or-None>, "budget": b}`` to start
  a trial (None = fresh config, id = promote that config), ``"IDLE"`` to wait,
  or ``None`` when the schedule is exhausted.
* ``report_trial(original_trial_id, new_trial_id)`` records the Trial created
  for the last decision.
* ``num_trials()`` → total slots across all rungs (the driver's trial budget).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Dict, Optional, Union


class AbstractPruner(ABC):
    def __init__(self, trial_metric_getter: Callable, direction: str = "max"):
        self.trial_metric_getter = trial_metric_getter
        self.direction = direction

    @abstractmethod
    def pruning_routine(self) -> Union[Dict, str, None]:
        ...

    @abstractmethod
    def report_trial(self, original_trial_id: Optional[str], new_trial_id: str) -> None:
        ...

    @abstractmethod
    def num_trials(self) -> int:
        ...
