"""Grid search over DISCRETE/CATEGORICAL axes (reference optimizer/gridsearch.py:23-92).

Continuous (DOUBLE) axes are gridded with ``grid_points`` evenly spaced values —
a capability the reference rejects outright (gridsearch.py:83-92); INTEGER axes
enumerate their full range when small, else ``grid_points`` evenly spaced ints.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Union

import numpy as np

from maggy_tpu_torch.optimizer.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial


class GridSearch(AbstractOptimizer):
    def __init__(self, grid_points: int = 5, **kwargs):
        super().__init__(**kwargs)
        self.grid_points = int(grid_points)

    @classmethod
    def axis_values(cls, searchspace: Searchspace, grid_points: int = 5) -> List[list]:
        axes = []
        for item in searchspace.items():
            t, v = item["type"], item["values"]
            if t in (Searchspace.DISCRETE, Searchspace.CATEGORICAL):
                axes.append(list(v))
            elif t == Searchspace.INTEGER:
                lo, hi = v
                if hi - lo + 1 <= grid_points:
                    axes.append(list(range(lo, hi + 1)))
                else:
                    axes.append(sorted({int(round(x)) for x in np.linspace(lo, hi, grid_points)}))
            else:  # DOUBLE
                axes.append([float(x) for x in np.linspace(v[0], v[1], grid_points)])
        return axes

    @classmethod
    def get_num_trials(cls, searchspace: Searchspace, grid_points: int = 5) -> int:
        """Cartesian-product size; consumed by the driver to override num_trials
        (reference gridsearch.py:33-43 + optimization_driver.py:91-93)."""
        n = 1
        for axis in cls.axis_values(searchspace, grid_points):
            n *= len(axis)
        return n

    def initialize(self) -> None:
        names = self.searchspace.keys()
        axes = self.axis_values(self.searchspace, self.grid_points)
        self._buffer = [dict(zip(names, combo)) for combo in itertools.product(*axes)]

    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        if self._buffer:
            return self.create_trial(self._buffer.pop(0), sample_type="grid")
        return None
