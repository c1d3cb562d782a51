"""Asynchronous Bayesian-optimization base.

Capability parity with the reference ``maggy/optimizer/bayes/base.py:26-681``:
a random warmup buffer, an exploration ``random_fraction``, per-budget surrogate
models, busy-trial imputation (constant liar) so parallel workers do not pile
onto the same optimum, and duplicate-config rejection with a bounded random
fallback. Surrogates live in numpy (GP) — no skopt/statsmodels (§2.9).

Async contract: ``get_suggestion`` is called by the driver's digestion thread
whenever a worker needs a config; observations are whatever sits in
``final_store`` at that moment — there is no synchronous batch.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Dict, Optional, Union

import numpy as np

from maggy_tpu_torch.optimizer.abstractoptimizer import IDLE, AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class BaseAsyncBO(AbstractOptimizer):
    def __init__(
        self,
        num_warmup_trials: int = 15,
        random_fraction: float = 0.33,
        imputation: str = "cl_min",
        multi_fidelity: str = "per_rung",
        interim_rows: int = 0,
        **kwargs,
    ):
        """``multi_fidelity`` (only relevant with a pruner): "per_rung" trains
        one surrogate per budget rung; "augment" trains a single surrogate over
        budget-augmented final metrics z=[x, b/b_max] using ALL observations.
        ``interim_rows > 0`` additionally emits up to that many rows per trial
        from its heartbeat metric history at fractional budgets — the
        reference's interim-results augmentation (bayes/base.py:459-641).
        ``imputation="kb"`` is kriging believer (reference gp.py:329-373):
        busy trials are imputed at the surrogate's posterior mean rather than
        a constant — surrogate-specific, provided by GP via
        :meth:`_impute_busy`."""
        super().__init__(**kwargs)
        if not 0 <= random_fraction <= 1:
            raise ValueError("random_fraction must be in [0, 1]")
        if imputation not in ("cl_min", "cl_max", "cl_mean", "kb"):
            raise ValueError("imputation must be one of cl_min/cl_max/cl_mean/kb")
        if multi_fidelity not in ("per_rung", "augment"):
            raise ValueError("multi_fidelity must be per_rung or augment")
        self.num_warmup_trials = int(num_warmup_trials)
        self.random_fraction = float(random_fraction)
        self.imputation = imputation
        self.multi_fidelity = multi_fidelity
        self.interim_rows = int(interim_rows)

    def initialize(self) -> None:
        warmup = min(self.num_warmup_trials, self.num_trials)
        self._warmup_buffer = [
            self.searchspace.sample(self._py_rng) for _ in range(warmup)
        ]
        self.models: Dict[Optional[float], object] = {}

    # ------------------------------------------------------------------ interface

    @abstractmethod
    def fit_model(self, X: np.ndarray, y: np.ndarray):
        """Fit and return a surrogate for (X, y) in the unit cube (y minimized)."""

    @abstractmethod
    def sample_from_model(self, model, fixed_last: Optional[float] = None) -> np.ndarray:
        """Propose the next point in the unit cube from a fitted surrogate.

        ``fixed_last``: multi-fidelity augmentation — the model's last input
        dimension is a normalized budget pinned to this value; the returned
        vector EXCLUDES that coordinate."""

    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        if self.pruner is not None:
            decision = self.pruner.pruning_routine()
            if decision == "IDLE":
                return IDLE
            if decision is None:
                return None
            return self._pruner_trial(decision)

        if self.num_created >= self.num_trials:
            return IDLE if self.trial_store else None

        # 1. warmup: pre-sampled random configs
        while self._warmup_buffer:
            params = self._warmup_buffer.pop(0)
            if not self.hparams_exist(params):
                return self.create_trial(params, sample_type="warmup")

        # 2. exploration fraction stays random forever (async BO robustness)
        if self.rng.random() < self.random_fraction:
            params = self._unique_random()
            if params is not None:
                return self.create_trial(params, sample_type="random")
            return IDLE if self.trial_store else None

        # 3. model-based proposal
        params = self._model_proposal()
        if params is not None:
            return self.create_trial(params, sample_type="model")
        params = self._unique_random()
        if params is not None:
            return self.create_trial(params, sample_type="random")
        return IDLE if self.trial_store else None

    # ------------------------------------------------------------------ internals

    def _pruner_trial(self, decision) -> Trial:
        def fresh():
            params = self._model_proposal(budget=decision["budget"])
            if params is not None:
                return params, "model"
            return self._unique_random(), "random"

        return self.pruner_trial(decision, fresh)

    def _unique_random(self, attempts: int = 20) -> Optional[dict]:
        for _ in range(attempts):
            params = self.searchspace.sample(self._py_rng)
            if not self.hparams_exist(params):
                return params
        return None

    def _training_set(self, budget: Optional[float] = None):
        """(X, y) at one budget rung (None = budget-less experiment) with
        busy-location imputation: in-flight configs get a constant-liar value so
        the acquisition avoids re-proposing them (reference bayes/base.py:400-457).
        X and y come from the same `_observed` filter, so they always align."""
        X_parts, y_parts = [], []
        X_done = self.get_hparams_array(budget)
        y_done = self.get_metrics_array(budget)
        if X_done.size:
            X_parts.append(X_done)
            y_parts.append(y_done)
        if y_done.size and self.trial_store:
            busy = self.searchspace.transform_many(
                [
                    self._strip_budget(t.params)
                    for t in self.trial_store.values()
                    if budget is None or t.params.get("budget") == budget
                ]
            )
            if busy.size:
                X_parts.append(busy)
                y_parts.append(self._impute_busy(X_done, y_done, busy))
        if not X_parts:
            return None, None
        return np.concatenate(X_parts), np.concatenate(y_parts)

    def _model_budget(self, target_budget: Optional[float]) -> Optional[float]:
        """Train the surrogate at the largest budget rung with enough
        observations (per-budget models, reference bayes/base.py:136-139);
        fall back to the target rung itself."""
        if target_budget is None:
            return None
        need = max(3, len(self.searchspace) + 1)
        budgets = sorted(
            {
                t.params["budget"]
                for t in self.final_store
                if "budget" in t.params and t.final_metric is not None
            },
            reverse=True,
        )
        for b in budgets:
            if len(self._observed(b)) >= need:
                return b
        return target_budget

    def _liar(self, y_done: np.ndarray) -> float:
        """Constant-liar value for busy-trial imputation ("kb" surrogates
        override :meth:`_impute_busy`; the mean is their fallback)."""
        return {
            "cl_min": float(y_done.min()),
            "cl_max": float(y_done.max()),
            "cl_mean": float(y_done.mean()),
            "kb": float(y_done.mean()),
        }[self.imputation]

    def _impute_busy(
        self, X_done: np.ndarray, y_done: np.ndarray, X_busy: np.ndarray
    ) -> np.ndarray:
        """Imputed y for in-flight configs: constant liar by default;
        surrogates supporting kriging believer override this."""
        return np.full(X_busy.shape[0], self._liar(y_done))

    def _augmented_training_set(self, target_budget: Optional[float]):
        """[x, b/b_max] design over ALL observations + busy imputation; returns
        (X_aug, y, b_norm) with b_norm the normalized target coordinate."""
        max_b = self.get_max_budget() or target_budget or 1.0
        obs = self._observed()
        if not obs:
            return None, None, 1.0
        X = self.searchspace.transform_many([self._strip_budget(t.params) for t in obs])
        b = np.asarray(
            [t.params.get("budget", max_b) / max_b for t in obs], dtype=np.float64
        )
        # y derived from the SAME `obs` list so X/y rows always align
        y = np.asarray(
            [
                -t.final_metric if self.direction == "max" else t.final_metric
                for t in obs
            ],
            dtype=np.float64,
        )
        X_aug = np.concatenate([X, b[:, None]], axis=1)
        # busy-trial imputation learns from FINAL metrics only, before interim
        # rows dilute y with early-training values
        X_final, y_final = (X_aug, y) if self.trial_store and y.size else (None, None)
        if self.interim_rows > 0:
            # interim observations: the metric after the j-th of n heartbeats of
            # a budget-b trial sits at fractional budget (j+1)/n * b/b_max —
            # scaled by position in the trial's OWN history, since heartbeat
            # step numbering is user-defined and not in budget units
            extra_X, extra_y = [], []
            for t, x_row, b_frac in zip(obs, X, b):
                n_hist = len(t.metric_history)
                if n_hist == 0:
                    continue
                idx = (
                    np.linspace(0, n_hist - 1, self.interim_rows).astype(int)
                    if n_hist > self.interim_rows
                    else np.arange(n_hist)
                )
                for j in idx:
                    frac = (j + 1) / n_hist * b_frac
                    m = t.metric_history[j]
                    extra_X.append(np.concatenate([x_row, [frac]]))
                    extra_y.append(-m if self.direction == "max" else m)
            if extra_X:
                X_aug = np.concatenate([X_aug, np.stack(extra_X)])
                y = np.concatenate([y, np.asarray(extra_y, dtype=np.float64)])
        if self.trial_store and X_final is not None:
            busy = list(self.trial_store.values())
            Xb = self.searchspace.transform_many(
                [self._strip_budget(t.params) for t in busy]
            )
            bb = np.asarray(
                [t.params.get("budget", max_b) / max_b for t in busy],
                dtype=np.float64,
            )
            if Xb.size:
                Xb_aug = np.concatenate([Xb, bb[:, None]], axis=1)
                X_aug = np.concatenate([X_aug, Xb_aug])
                y = np.concatenate([y, self._impute_busy(X_final, y_final, Xb_aug)])
        b_norm = (target_budget / max_b) if target_budget else 1.0
        return X_aug, y, float(min(b_norm, 1.0))

    def _model_proposal(
        self, dedup_attempts: int = 3, budget: Optional[float] = None
    ) -> Optional[dict]:
        fixed_coord = None
        if self.multi_fidelity == "augment" and budget is not None:
            X, y, b_norm = self._augmented_training_set(budget)
            fixed_coord = b_norm
            model_key = "augment"
        else:
            model_budget = self._model_budget(budget)
            X, y = self._training_set(model_budget)
            model_key = model_budget
        # augment mode has one extra (budget) column — require one more row
        min_rows = max(3, (X.shape[1] if X is not None else 0) + 1,
                       len(self.searchspace) + 1)
        if X is None or len(X) < min_rows:
            return None
        try:
            model = self.fit_model(X, y)
        except Exception:  # singular kernels etc. — fall back to random
            return None
        self.models[model_key] = model
        for _ in range(dedup_attempts):
            vec = np.clip(
                self.sample_from_model(model, fixed_last=fixed_coord), 0.0, 1.0
            )
            params = self.searchspace.inverse_transform(vec)
            if not self.hparams_exist(params):
                return params
        return None
