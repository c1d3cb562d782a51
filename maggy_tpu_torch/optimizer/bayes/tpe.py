"""Tree-structured Parzen Estimator (BOHB-style).

First-party numpy implementation replacing the reference's statsmodels
KDEMultivariate dependency (reference optimizer/bayes/tpe.py:31-266; §2.9).
Observations are split at the ``gamma`` quantile into good/bad sets with the
BOHB counting rule, per-dimension Gaussian KDEs (Scott bandwidth, widened by
``bw_factor`` when sampling) model each set in the unit cube, and the proposal
maximizes EI = pdf_good / pdf_bad over candidates drawn from the good KDE —
truncated normals keep every candidate inside [0, 1].
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from maggy_tpu_torch.optimizer.bayes.base import BaseAsyncBO


def _scott_bw(X: np.ndarray) -> np.ndarray:
    n, d = X.shape
    sigma = X.std(axis=0) + 1e-3
    return sigma * n ** (-1.0 / (d + 4))


class _KDE:
    """Product of per-dimension Gaussian kernels over points in the unit cube."""

    def __init__(self, X: np.ndarray, bw: np.ndarray):
        self.X = X
        self.bw = np.maximum(bw, 1e-3)

    def marginal(self, n_dims: int) -> "_KDE":
        """Marginal over the first ``n_dims`` (per-dim product kernels
        marginalize by dropping factors)."""
        return _KDE(self.X[:, :n_dims], self.bw[:n_dims])

    def pdf(self, Q: np.ndarray) -> np.ndarray:
        # [q, n, d] standardized distances
        z = (Q[:, None, :] - self.X[None, :, :]) / self.bw
        kern = np.exp(-0.5 * z * z) / (self.bw * math.sqrt(2 * math.pi))
        return np.maximum(kern.prod(-1).mean(-1), 1e-32)

    def sample(self, rng: np.random.Generator, n: int, bw_factor: float) -> np.ndarray:
        idx = rng.integers(0, len(self.X), n)
        centers = self.X[idx]
        bw = self.bw * bw_factor
        out = np.empty_like(centers)
        for j in range(centers.shape[1]):
            # truncated normal per dimension via resampling, clip as backstop
            col = rng.normal(centers[:, j], bw[j])
            bad = (col < 0) | (col > 1)
            retry = 0
            while bad.any() and retry < 8:
                col[bad] = rng.normal(centers[bad, j], bw[j])
                bad = (col < 0) | (col > 1)
                retry += 1
            out[:, j] = np.clip(col, 0.0, 1.0)
        return out


class TPE(BaseAsyncBO):
    def __init__(
        self,
        gamma: float = 0.15,
        num_samples: int = 64,
        bw_factor: float = 3.0,
        min_points: int = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if not 0 < gamma < 1:
            raise ValueError("gamma must be in (0, 1)")
        self.gamma = gamma
        self.num_samples = int(num_samples)
        self.bw_factor = float(bw_factor)
        self.min_points = min_points

    def _split(self, X: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """BOHB split: n_good = max(d+1, gamma*n), n_bad = max(d+1, rest)
        (reference tpe.py:191-221)."""
        d = X.shape[1]
        n = len(X)
        order = np.argsort(y)  # ascending: best (smallest) first
        n_good = max(d + 1, int(math.ceil(self.gamma * n)))
        n_good = min(n_good, n - 1) if n > 1 else n
        good = X[order[:n_good]]
        bad = X[order[n_good:]]
        if len(bad) < d + 1:
            bad = X[order[max(0, n - (d + 1)) :]]
        return good, bad

    def fit_model(self, X: np.ndarray, y: np.ndarray):
        d = X.shape[1]
        need = self.min_points if self.min_points is not None else 2 * (d + 1)
        if len(X) < need:
            raise ValueError("not enough observations for TPE")
        good, bad = self._split(X, y)
        return (_KDE(good, _scott_bw(good)), _KDE(bad, _scott_bw(bad)))

    def sample_from_model(self, model, fixed_last=None) -> np.ndarray:
        kde_good, kde_bad = model
        cand = kde_good.sample(self.rng, self.num_samples, self.bw_factor)
        if fixed_last is not None:
            # score over the free dims only: a pinned budget coordinate far
            # from the observed budgets would zero both pdfs and flatten EI
            d_free = cand.shape[1] - 1
            free = cand[:, :d_free]
            ei = kde_good.marginal(d_free).pdf(free) / kde_bad.marginal(d_free).pdf(free)
            return free[int(np.argmax(ei))]
        ei = kde_good.pdf(cand) / kde_bad.pdf(cand)
        return cand[int(np.argmax(ei))]
