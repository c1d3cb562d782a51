"""Failure classification, retry budgets, and worker quarantine.

The scheduling question on a preemptible pod is never "did something fail"
but "is it worth paying for again": a worker death or RPC loss says nothing
about the trial it interrupted (retry it elsewhere), while an exception
raised out of ``train_fn`` will raise again on any worker (fail fast).
These are the policy objects the drivers consult; they hold no driver state
and are independently testable.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"


def classify_failure(exc: BaseException) -> str:
    """Classify a worker-side failure for the retry machinery.

    TRANSIENT — the *substrate* died out from under the work (worker/host
    death, chaos kill, RPC transport loss, OS-level connection trouble):
    rerunning the same work elsewhere can succeed. DETERMINISTIC — the work
    itself raised (a train_fn bug, bad hparams, OOM from the model shape):
    rerunning burns budget to fail identically, so the driver fails fast.
    """
    from maggy_tpu_torch.exceptions import RpcError, WorkerLost

    if isinstance(
        exc, (WorkerLost, RpcError, ConnectionError, TimeoutError, OSError)
    ):
        return TRANSIENT
    return DETERMINISTIC


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-trial retry budget with exponential backoff + deterministic jitter.

    ``delay(attempt)`` is a pure function of (policy, attempt): the jitter is
    seeded from them, so a requeue schedule is reproducible run-to-run (the
    chaos tests depend on that) while still de-synchronizing workers that
    share a policy but retry different attempts.
    """

    max_retries: int = 2
    backoff_base: float = 0.5  # seconds before the first retry
    backoff_factor: float = 2.0
    backoff_cap: float = 30.0
    jitter: float = 0.25  # fraction of the delay randomized away
    seed: int = 0

    @classmethod
    def from_config(cls, config: Any) -> "RetryPolicy":
        """Build from experiment-config knobs with env overrides
        (``MAGGY_TPU_TRIAL_RETRIES`` / ``MAGGY_TPU_RETRY_BACKOFF``)."""
        return cls(
            max_retries=_env_int(
                "MAGGY_TPU_TRIAL_RETRIES", int(getattr(config, "trial_retries", 2))
            ),
            backoff_base=_env_float(
                "MAGGY_TPU_RETRY_BACKOFF",
                float(getattr(config, "retry_backoff", 0.5)),
            ),
            seed=int(getattr(config, "seed", None) or 0),
        )

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based): exponential growth,
        capped, with deterministic downward jitter."""
        base = min(
            self.backoff_base * self.backoff_factor ** max(0, attempt),
            self.backoff_cap,
        )
        r = random.Random(self.seed * 1_000_003 + attempt).random()
        return base * (1.0 - self.jitter * r)


class QuarantineTracker:
    """Take a repeatedly-lethal worker out of scheduling.

    A worker whose *consecutive* trials keep dying (flaky host, wedged
    accelerator, bad NIC) is quarantined for ``cooldown`` seconds: the driver
    stops assigning to it and stops respawning it. Any successful trial
    resets the streak. After the cooldown the worker re-enters on probation —
    the streak restarts one below the threshold, so a single further death
    re-quarantines it immediately. Thread-safe.
    """

    def __init__(self, threshold: int = 3, cooldown: float = 300.0):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self._lock = threading.Lock()
        self._streak: Dict[int, int] = {}
        self._until: Dict[int, float] = {}

    def record_failure(self, pid: int, now: Optional[float] = None) -> bool:
        """Record one lost/dead trial on ``pid``; True when this tips the
        worker into quarantine."""
        now = time.time() if now is None else now
        with self._lock:
            streak = self._streak.get(pid, 0) + 1
            self._streak[pid] = streak
            if streak >= self.threshold and pid not in self._until:
                self._until[pid] = now + self.cooldown
                return True
            return False

    def record_success(self, pid: int) -> None:
        with self._lock:
            self._streak.pop(pid, None)
            self._until.pop(pid, None)

    def is_quarantined(self, pid: int, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        with self._lock:
            until = self._until.get(pid)
            if until is None:
                return False
            if now < until:
                return True
            # cooldown over: release on probation (one more death re-trips)
            self._until.pop(pid, None)
            self._streak[pid] = self.threshold - 1
            return False

    def quarantined(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        with self._lock:
            return sorted(pid for pid, until in self._until.items() if now < until)

    def snapshot(self) -> Dict[str, Any]:
        """For STATUS: remaining quarantine seconds per worker."""
        now = time.time()
        with self._lock:
            return {
                str(pid): round(until - now, 1)
                for pid, until in self._until.items()
                if until > now
            }
