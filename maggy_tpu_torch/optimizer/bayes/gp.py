"""Gaussian-process surrogate with Matern-5/2 kernel and EI/PI/LCB acquisitions.

First-party numpy implementation replacing the reference's skopt dependency
(reference optimizer/bayes/gp.py:34-373 wraps sklearn's GaussianProcessRegressor
with ConstantKernel x Matern(nu=2.5); §2.9 requires re-implementation). Kernel
hyperparameters (amplitude, ARD lengthscales, noise) are fit by maximizing the
log marginal likelihood with multi-restart L-BFGS-B; the acquisition is
optimized by dense random sampling plus a local refinement, all in the unit
cube the Searchspace transform defines.
"""

from __future__ import annotations

import math

import numpy as np

from maggy_tpu_torch.optimizer.bayes.base import BaseAsyncBO

_SQRT5 = math.sqrt(5.0)


def _matern52(X1: np.ndarray, X2: np.ndarray, lengthscales: np.ndarray) -> np.ndarray:
    d = (X1[:, None, :] - X2[None, :, :]) / lengthscales
    r = np.sqrt(np.maximum((d * d).sum(-1), 1e-30))
    sr = _SQRT5 * r
    return (1.0 + sr + sr * sr / 3.0) * np.exp(-sr)


class _FittedGP:
    def __init__(self, X, y, amp2, lengthscales, noise2):
        self.X = X
        self.y_mean = y.mean()
        self.y_std = y.std() + 1e-12
        self.y = (y - self.y_mean) / self.y_std
        self.amp2 = amp2
        self.lengthscales = lengthscales
        self.noise2 = noise2
        K = amp2 * _matern52(X, X, lengthscales) + noise2 * np.eye(len(X))
        self.L = np.linalg.cholesky(K + 1e-10 * np.eye(len(X)))
        self.alpha = np.linalg.solve(
            self.L.T, np.linalg.solve(self.L, self.y)
        )

    def predict(self, Xs: np.ndarray):
        Ks = self.amp2 * _matern52(Xs, self.X, self.lengthscales)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(self.amp2 - (v * v).sum(0), 1e-12)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std

    def log_marginal_likelihood(self):
        return float(
            -0.5 * self.y @ self.alpha
            - np.log(np.diag(self.L)).sum()
            - 0.5 * len(self.y) * math.log(2 * math.pi)
        )


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


class GP(BaseAsyncBO):
    """Async GP-BO. ``acq_fun`` in {"ei", "pi", "lcb", "asy_ts"}; minimizes
    internally. ``asy_ts`` is asynchronous Thompson sampling (reference
    gp.py:158-162): every proposal draws one function sample from the GP
    posterior over a candidate set and takes its argmin — naturally diverse
    under parallel workers, no liar needed. ``imputation="kb"`` (kriging
    believer, reference gp.py:329-373) imputes busy trials at the posterior
    mean of a GP fitted on the finished observations."""

    def __init__(
        self,
        acq_fun: str = "ei",
        acq_samples: int = 1024,
        kappa: float = 1.96,
        xi: float = 0.01,
        n_restarts: int = 3,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if acq_fun not in ("ei", "pi", "lcb", "asy_ts"):
            raise ValueError("acq_fun must be ei, pi, lcb or asy_ts")
        self.acq_fun = acq_fun
        self.acq_samples = int(acq_samples)
        self.kappa = kappa
        self.xi = xi
        self.n_restarts = int(n_restarts)

    # ------------------------------------------------------------------ fitting

    def fit_model(self, X: np.ndarray, y: np.ndarray) -> _FittedGP:
        d = X.shape[1]

        def nll(theta):
            amp2 = math.exp(theta[0])
            ls = np.exp(theta[1 : 1 + d])
            noise2 = math.exp(theta[-1])
            try:
                gp = _FittedGP(X, y, amp2, ls, noise2)
            except np.linalg.LinAlgError:
                return 1e10
            return -gp.log_marginal_likelihood()

        best_theta, best_val = None, np.inf
        starts = [np.zeros(d + 2)]
        for _ in range(self.n_restarts - 1):
            starts.append(
                np.concatenate(
                    [
                        self.rng.uniform(-1, 1, 1),
                        self.rng.uniform(-2, 1, d),
                        self.rng.uniform(-8, -2, 1),
                    ]
                )
            )
        bounds = [(-4, 4)] + [(-5, 3)] * d + [(-10, 0)]
        try:
            from scipy.optimize import minimize

            for x0 in starts:
                res = minimize(nll, x0, method="L-BFGS-B", bounds=bounds)
                if res.fun < best_val:
                    best_val, best_theta = res.fun, res.x
        except ImportError:  # pragma: no cover - scipy ships with jax images
            for x0 in starts:
                val = nll(x0)
                if val < best_val:
                    best_val, best_theta = val, x0
        theta = best_theta if best_theta is not None else np.zeros(d + 2)
        return _FittedGP(
            X,
            y,
            math.exp(theta[0]),
            np.exp(theta[1 : 1 + d]),
            math.exp(theta[-1]),
        )

    # ------------------------------------------------------------------ acquisition

    def _acquisition(self, model: _FittedGP, Xs: np.ndarray) -> np.ndarray:
        """Lower is better (we pick argmin)."""
        mu, sigma = model.predict(Xs)
        if self.acq_fun == "lcb":
            return mu - self.kappa * sigma
        y_best = model.y.min() * model.y_std + model.y_mean
        z = (y_best - mu - self.xi) / sigma
        if self.acq_fun == "ei":
            ei = (y_best - mu - self.xi) * _norm_cdf(z) + sigma * _norm_pdf(z)
            return -ei
        return -_norm_cdf(z)  # pi

    def _thompson_draw(self, model: _FittedGP, Xs: np.ndarray) -> np.ndarray:
        """One joint sample from the GP posterior at ``Xs`` (standardized y
        space is fine — argmin is scale-invariant)."""
        mu, _ = model.predict(Xs)
        Ks = model.amp2 * _matern52(Xs, model.X, model.lengthscales)
        v = np.linalg.solve(model.L, Ks.T)
        cov = model.amp2 * _matern52(Xs, Xs, model.lengthscales) - v.T @ v
        jitter = 1e-8 * max(model.amp2, 1.0)
        for _ in range(3):  # roundoff can defeat a fixed jitter at large amp2
            try:
                Lp = np.linalg.cholesky(cov + jitter * np.eye(len(Xs)))
                return mu + (Lp @ self.rng.standard_normal(len(Xs))) * model.y_std
            except np.linalg.LinAlgError:
                jitter *= 1e3
        # joint draw unsalvageable: independent marginal draws still rank
        # candidates usefully and never crash the suggestion loop
        mu, sigma = model.predict(Xs)
        return mu + sigma * self.rng.standard_normal(len(Xs))

    def _impute_busy(self, X_done, y_done, X_busy) -> np.ndarray:
        if self.imputation != "kb":
            return super()._impute_busy(X_done, y_done, X_busy)
        try:
            believer = self.fit_model(X_done, y_done)
            mu, _ = believer.predict(X_busy)
            return np.asarray(mu)
        except Exception:  # singular kernel etc. — constant fallback
            return super()._impute_busy(X_done, y_done, X_busy)

    def sample_from_model(self, model: _FittedGP, fixed_last=None) -> np.ndarray:
        d = model.X.shape[1]
        d_free = d - 1 if fixed_last is not None else d

        def embed(x_free):
            if fixed_last is None:
                return x_free
            pad = np.full((*x_free.shape[:-1], 1), fixed_last)
            return np.concatenate([x_free, pad], axis=-1)

        if self.acq_fun == "asy_ts":
            # joint posterior sampling is O(n^3) in the candidate count
            n = min(self.acq_samples, 512)
            Xs = self.rng.random((n, d_free))
            draw = self._thompson_draw(model, embed(Xs))
            return Xs[int(np.argmin(draw))]

        Xs = self.rng.random((self.acq_samples, d_free))
        acq = self._acquisition(model, embed(Xs))
        x0 = Xs[int(np.argmin(acq))]
        # local refinement of the incumbent candidate (free dims only)
        try:
            from scipy.optimize import minimize

            res = minimize(
                lambda x: float(self._acquisition(model, embed(x)[None, :])[0]),
                x0,
                method="L-BFGS-B",
                bounds=[(0.0, 1.0)] * d_free,
            )
            if res.success and res.fun <= float(
                self._acquisition(model, embed(x0)[None, :])[0]
            ):
                return np.asarray(res.x)
        except ImportError:  # pragma: no cover
            pass
        return x0
