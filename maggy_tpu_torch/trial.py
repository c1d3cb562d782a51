"""Trial record and state machine: the port's copy of :mod:`maggy_tpu.trial`.

Capability parity with the reference ``maggy/trial.py`` (trial.py:24-176): the five
states PENDING/SCHEDULED/RUNNING/ERROR/FINALIZED, a deterministic trial id (16-char
md5 prefix over the sorted-params JSON — same scheme as trial.py:110-136 so
*optimization* trial ids are comparable across frameworks; ablation trial ids are
NOT comparable: the reference serializes groups via ``str(list(set))``
(loco.py:249), which depends on set iteration order, so we use a deterministic
``"|".join(sorted(group))`` under the ``ablated_component`` key instead),
thread-safe metric appends deduplicated by step, an early-stop flag, and JSON
(de)serialization.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _normalize_key(key: Any):
    """Keys stay native (str/int/float/bool — numpy scalars coerced) so that
    ``json.dumps(..., sort_keys=True)`` sorts and stringifies them exactly
    like the reference does (int keys sort numerically, not lexically);
    arbitrary objects raise instead of silently stringifying to a
    per-process repr."""
    if isinstance(key, (str, bool, int, float)):
        return key
    if isinstance(key, np.integer):
        return int(key)
    if isinstance(key, np.floating):
        return float(key)
    raise TypeError(
        f"Trial param key {key!r} of type {type(key).__name__} is not "
        "JSON-serializable; use str/int/float/bool keys"
    )


def _normalize_value(value: Any) -> Any:
    """Coerce numpy scalars, torch tensors and containers to JSON-native types so that
    np.int64(5) and 5 hash to the same trial id and travel the RPC wire as
    numbers, not strings. Non-JSON-native leaves raise, like the reference
    (trial.py:110-136 json.dumps without a default)."""
    if isinstance(value, (str, bool)) or value is None:
        return value
    if isinstance(value, (int, float)):
        return value
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return _normalize_value(value.item())
        return [_normalize_value(v) for v in value.tolist()]
    if isinstance(value, torch.Tensor):
        # on any device: numpy takes no CUDA tensor, so move it first
        value = value.detach().cpu()
        return _normalize_value(value.item() if value.ndim == 0 else value.tolist())
    if hasattr(value, "ndim") and hasattr(value, "item"):
        # other numpy-protocol arrays, any rank
        arr = np.asarray(value)
        return _normalize_value(arr.item() if arr.ndim == 0 else arr)
    if isinstance(value, (list, tuple)):
        return [_normalize_value(v) for v in value]
    if isinstance(value, dict):
        return {_normalize_key(k): _normalize_value(v) for k, v in value.items()}
    raise TypeError(
        f"Trial param value {value!r} of type {type(value).__name__} is not "
        "JSON-serializable; use int/float/str/bool/None or containers thereof"
    )


class Trial:
    PENDING = "PENDING"
    SCHEDULED = "SCHEDULED"
    RUNNING = "RUNNING"
    ERROR = "ERROR"
    FINALIZED = "FINALIZED"

    STATES = (PENDING, SCHEDULED, RUNNING, ERROR, FINALIZED)

    def __init__(
        self,
        params: Dict[str, Any],
        trial_type: str = "optimization",
        info_dict: Optional[Dict[str, Any]] = None,
    ):
        if not isinstance(params, dict):
            raise TypeError(f"Trial params must be a dict, got {type(params).__name__}")
        self.params = _normalize_value(dict(params))
        # params are normalized above; hash directly (compute_id re-normalizes
        # for external callers passing raw dicts)
        self.trial_type = trial_type
        self.trial_id = self._id_of_normalized(self.params)
        self.status = Trial.PENDING
        self.info_dict = dict(info_dict or {})

        self.final_metric: Optional[float] = None
        self.metric_history: List[float] = []
        self.step_history: List[int] = []
        self.start: Optional[float] = None
        self.duration: Optional[float] = None
        self.assigned_to: Optional[int] = None  # partition/executor id

        self._early_stop = False
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ identity

    @staticmethod
    def compute_id(params: Dict[str, Any]) -> str:
        """16-char md5 prefix of the canonical params JSON — bit-identical to
        the reference's ids for JSON-native params (trial.py:110-136 uses
        ``json.dumps(params, sort_keys=True)`` with default separators; the
        reference suite's expected value "3d1cc9fdb1d4d001" passes here).
        Params are normalized first so numpy scalars hash like native ones;
        non-serializable values raise TypeError like the reference."""
        return Trial._id_of_normalized(_normalize_value(params))

    @staticmethod
    def _id_of_normalized(params: Dict[str, Any]) -> str:
        try:
            canonical = json.dumps(params, sort_keys=True)
        except TypeError as e:
            # json.dumps raises an opaque '<' comparison error on mixed-type
            # keys (the reference crashes identically; we just say why)
            if "not supported between instances" in str(e):
                raise TypeError(
                    f"Trial params must not mix key types within one dict "
                    f"(json.dumps sort_keys cannot order them): {params!r}"
                ) from e
            raise
        return hashlib.md5(canonical.encode("utf-8")).hexdigest()[:16]

    # ------------------------------------------------------------------ lifecycle

    def schedule(self, partition_id: int) -> None:
        with self._lock:
            self.status = Trial.SCHEDULED
            self.assigned_to = partition_id

    def begin(self) -> None:
        with self._lock:
            self.status = Trial.RUNNING
            self.start = time.time()

    def finalize(self, final_metric: Optional[float] = None) -> None:
        with self._lock:
            if final_metric is not None:
                self.final_metric = float(final_metric)
            self.status = Trial.FINALIZED
            if self.start is not None:
                self.duration = time.time() - self.start

    def error(self) -> None:
        with self._lock:
            self.status = Trial.ERROR

    def reset_for_retry(self) -> None:
        """Return a trial lost to a transient failure (worker death / RPC
        loss) to PENDING for requeue: identity and params are kept, run
        state — metrics, timing, assignment, early-stop flag — is cleared so
        the retry reports a clean history. The retry counter lives in
        ``info_dict['retries']`` and survives (the driver owns it)."""
        with self._lock:
            self.status = Trial.PENDING
            self.assigned_to = None
            self.start = None
            self.duration = None
            self.metric_history = []
            self.step_history = []
            self._early_stop = False

    # ------------------------------------------------------------------ metrics

    def append_metric(self, metric: float, step: Optional[int] = None) -> bool:
        """Record one (metric, step) observation; duplicate steps are dropped
        (reference trial.py:93-108). Returns True if recorded."""
        with self._lock:
            if step is None:
                step = self.step_history[-1] + 1 if self.step_history else 0
            step = int(step)
            if self.step_history and step <= self.step_history[-1]:
                return False
            self.metric_history.append(float(metric))
            self.step_history.append(step)
            return True

    @property
    def metrics(self) -> List[float]:
        with self._lock:
            return list(self.metric_history)

    def running_avg(self, up_to_step: Optional[int] = None) -> Optional[float]:
        """Mean of metrics observed at steps <= ``up_to_step`` (median-rule substrate)."""
        with self._lock:
            vals = [
                m
                for m, s in zip(self.metric_history, self.step_history)
                if up_to_step is None or s <= up_to_step
            ]
        if not vals:
            return None
        return sum(vals) / len(vals)

    # ------------------------------------------------------------------ early stop

    def set_early_stop(self) -> None:
        with self._lock:
            self._early_stop = True

    def get_early_stop(self) -> bool:
        with self._lock:
            return self._early_stop

    # ------------------------------------------------------------------ serialization

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "trial_id": self.trial_id,
                "trial_type": self.trial_type,
                "params": self.params,
                "status": self.status,
                "final_metric": self.final_metric,
                "metric_history": list(self.metric_history),
                "step_history": list(self.step_history),
                "start": self.start,
                "duration": self.duration,
                "early_stop": self._early_stop,
                "info_dict": self.info_dict,
            }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, default=str)

    @classmethod
    def from_dict(cls, payload: Dict[str, Any]) -> "Trial":
        t = cls(payload["params"], payload.get("trial_type", "optimization"))
        t.status = payload.get("status", Trial.PENDING)
        t.final_metric = payload.get("final_metric")
        t.metric_history = [float(m) for m in payload.get("metric_history", [])]
        t.step_history = [int(s) for s in payload.get("step_history", [])]
        t.start = payload.get("start")
        t.duration = payload.get("duration")
        t._early_stop = bool(payload.get("early_stop", False))
        t.info_dict = payload.get("info_dict", {}) or {}
        return t

    @classmethod
    def from_json(cls, payload: str) -> "Trial":
        return cls.from_dict(json.loads(payload))

    def __repr__(self) -> str:
        return (
            f"Trial(id={self.trial_id}, status={self.status}, "
            f"final_metric={self.final_metric}, params={self.params})"
        )
