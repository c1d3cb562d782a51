"""Per-tenant QoS: priority classes, the class-ordered admission queue, and
the weighted token-budget quota ledger.

A copy of :mod:`maggy_tpu.serve.qos` (the port imports nothing of the
JAX package); its locks are plain ``threading`` locks.

Requests carry a ``tenant`` (accounting identity) and a ``qos`` class
(scheduling identity). Three classes, in priority order::

    premium > standard > best_effort   (the wire default)

Two mechanisms share the decode capacity between them
(docs/fleet.md "QoS classes & graceful degradation"):

* **Priority admission** (:class:`QosQueue`): the scheduler admits the
  highest-priority non-empty class first, FIFO within a class. Requeues
  (preemption, page backpressure) go to the *front of their own class*, so
  a preempted premium stream still outranks queued premium arrivals but
  never jumps a class it doesn't belong to.
* **Weighted token quotas** (:class:`QuotaLedger`): each class's share of
  decode tokens over a sliding window is bounded by its weight. The ledger
  is work-conserving — an over-share class is only deferred while some
  under-share class has queued work — so quotas are a *guaranteed floor*
  for every class (premium cannot fully starve best-effort, and a
  best-effort flood cannot crowd premium out of its share), never idle
  capacity.

Preemption ordering reuses the same classes: under page pressure the
scheduler preempts the lowest class first, youngest within the class
(:meth:`Scheduler._preempt_for_pages`), and the PR-10 byte-identical resume
seam means a preempted premium stream still completes bit-exact.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import threading

PREMIUM = "premium"
STANDARD = "standard"
BEST_EFFORT = "best_effort"

# priority order: admission walks this left to right; preemption walks it
# right to left (lowest class is the first victim)
QOS_CLASSES: Tuple[str, ...] = (PREMIUM, STANDARD, BEST_EFFORT)
QOS_PRIORITY: Dict[str, int] = {c: i for i, c in enumerate(QOS_CLASSES)}

# default decode-token weights (premium:standard:best_effort); any class's
# windowed share above weight/total defers it while others wait
DEFAULT_WEIGHTS: Dict[str, float] = {PREMIUM: 8.0, STANDARD: 3.0, BEST_EFFORT: 1.0}

DEFAULT_QOS = BEST_EFFORT
DEFAULT_TENANT = "anon"


def validate_qos(qos: Optional[str]) -> str:
    """Normalize a wire/API qos value; raises ``ValueError`` on unknowns so
    a typo'd class fails the submit instead of silently scheduling it
    best-effort."""
    if qos is None or qos == "":
        return DEFAULT_QOS
    qos = str(qos)
    if qos not in QOS_PRIORITY:
        raise ValueError(
            f"unknown qos class {qos!r} (valid: {', '.join(QOS_CLASSES)})"
        )
    return qos


class QosQueue:
    """Class-ordered admission queue: one FIFO deque per QoS class.

    Not itself locked — every method is called under the scheduler's lock
    (the same discipline the old single deque followed); it is a data
    structure, not a concurrency boundary.
    """

    def __init__(self) -> None:
        self._queues: Dict[str, deque] = {c: deque() for c in QOS_CLASSES}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def append(self, req: Any) -> None:
        """Fresh arrival: back of its class."""
        self._queues[getattr(req, "qos", DEFAULT_QOS)].append(req)

    def requeue_front(self, req: Any) -> None:
        """Preempted / page-backpressured request: front of its class, so it
        outranks fresh arrivals of the same class but not higher classes."""
        self._queues[getattr(req, "qos", DEFAULT_QOS)].appendleft(req)

    def depths(self) -> Dict[str, int]:
        return {c: len(q) for c, q in self._queues.items()}

    def classes_waiting(self) -> List[str]:
        """Non-empty classes in priority order."""
        return [c for c in QOS_CLASSES if self._queues[c]]

    def pop_next(
        self, ledger: Optional["QuotaLedger"] = None, now: Optional[float] = None
    ) -> Tuple[Optional[Any], List[str]]:
        """The next request to admit plus the classes that were quota-deferred
        to reach it.

        Highest-priority non-empty class wins, unless the ledger says that
        class is over its windowed token share *and* some other class is
        waiting under share — then the best under-share class is served
        instead (the deferred, higher-priority classes are returned so the
        scheduler can count them). When every waiting class is over share
        the pick falls back to plain priority: quotas never idle a slot.
        """
        waiting = self.classes_waiting()
        if not waiting:
            return None, []
        choice = waiting[0]
        deferred: List[str] = []
        if ledger is not None and len(waiting) > 1:
            eligible = [c for c in waiting if not ledger.over_share(c, now)]
            if eligible and eligible[0] != choice:
                choice = eligible[0]
                deferred = waiting[: waiting.index(choice)]
        return self._queues[choice].popleft(), deferred


class QuotaLedger:
    """Sliding-window decode-token accounting per QoS class.

    The scheduler loop charges one token per emitted decode token
    (:meth:`charge`); admission asks :meth:`over_share` whether a class has
    exceeded its weighted share of the window. Tokens are accumulated into
    coarse time buckets so charging stays O(1) on the decode hot path and
    pruning is O(window / bucket).

    Charged from the scheduler loop thread and read by admission on the
    same thread, but also snapshotted by RPC-side ``stats()`` — hence the
    lock (pinned in ``tools/check_concurrency.py`` REQUIRED_MODELS).
    """

    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        window_s: float = 5.0,
        min_tokens: int = 32,
        bucket_s: float = 0.25,
    ):
        weights = dict(weights or DEFAULT_WEIGHTS)
        for c in QOS_CLASSES:
            weights.setdefault(c, 0.0)
        total = sum(w for w in weights.values() if w > 0) or 1.0
        self.weights = weights
        self.fractions = {c: max(0.0, w) / total for c, w in weights.items()}
        self.window_s = float(window_s)
        # below this many tokens in the window the ledger abstains: early
        # traffic must not be deferred on statistically-meaningless shares
        self.min_tokens = int(min_tokens)
        self.bucket_s = float(bucket_s)
        self._lock = threading.Lock()
        # (bucket_start_ts, {class: tokens}) oldest-first  # guarded-by: _lock
        self._buckets: deque = deque()

    # ------------------------------------------------------------------ write

    def charge(self, qos: str, tokens: int = 1, now: Optional[float] = None) -> None:  # thread-entry — charged from the scheduler's decode loop per emitted token
        now = time.time() if now is None else now
        start = now - (now % self.bucket_s)
        with self._lock:
            if not self._buckets or self._buckets[-1][0] != start:
                self._buckets.append((start, {}))
                self._prune(now)
            counts = self._buckets[-1][1]
            counts[qos] = counts.get(qos, 0) + int(tokens)

    def _prune(self, now: float) -> None:  # guarded-by: _lock
        cutoff = now - self.window_s - self.bucket_s
        while self._buckets and self._buckets[0][0] < cutoff:
            self._buckets.popleft()

    # ------------------------------------------------------------------- read

    def totals(self, now: Optional[float] = None) -> Dict[str, int]:
        """Tokens per class inside the window."""
        now = time.time() if now is None else now
        cutoff = now - self.window_s
        out: Dict[str, int] = {c: 0 for c in QOS_CLASSES}
        with self._lock:
            for start, counts in self._buckets:
                if start + self.bucket_s < cutoff:
                    continue
                for c, n in counts.items():
                    out[c] = out.get(c, 0) + n
        return out

    def shares(self, now: Optional[float] = None) -> Dict[str, float]:
        totals = self.totals(now)
        grand = sum(totals.values())
        if grand <= 0:
            return {c: 0.0 for c in totals}
        return {c: n / grand for c, n in totals.items()}

    def over_share(self, qos: str, now: Optional[float] = None) -> bool:
        """True when ``qos`` has consumed more than its weighted share of
        the window's decode tokens (and the window is statistically
        meaningful)."""
        totals = self.totals(now)
        grand = sum(totals.values())
        if grand < self.min_tokens:
            return False
        return totals.get(qos, 0) / grand > self.fractions.get(qos, 0.0)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        totals = self.totals(now)
        return {
            "window_s": self.window_s,
            "weights": dict(self.weights),
            "tokens": totals,
            "shares": {
                c: round(s, 4) for c, s in self.shares(now).items()
            },
        }
