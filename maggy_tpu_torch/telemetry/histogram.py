"""Fixed-log-bucket latency histogram.

The serving scheduler used to keep a 512-entry deque of raw TTFT samples and
sort it on every SSTATS poll — O(n log n) per poll, a hard sample cap that
silently forgets the past, and nothing two replicas could merge. This
primitive replaces it everywhere latencies are aggregated (TTFT, TPOT,
queue-wait, e2e, decode drain):

* **Fixed log-spaced buckets.** Bucket ``i`` covers
  ``[lo * growth**i, lo * growth**(i+1))`` milliseconds. With the defaults
  (``lo=0.05``, ``growth=1.15``, 128 buckets) the range runs ~0.05 ms to
  ~40 minutes at a constant ~7% relative resolution — percentile error is
  bounded by the bucket width, never by sample count.
* **O(1) observe** (one ``math.log`` + a list increment), unbounded sample
  count, constant memory.
* **Mergeable.** Two histograms with the same geometry add bucket-wise —
  the fleet router folds per-replica histograms into one fleet histogram
  with exact total counts (``merge``), which no percentile-of-percentiles
  scheme can do honestly.
* **JSON-portable.** ``to_dict``/``from_dict`` round-trip a sparse
  ``{index: count}`` encoding, small enough to ride in SSTATS replies,
  heartbeat snapshots, and telemetry JSONL.

Percentiles are reported at the geometric midpoint of the selected bucket;
``attainment(slo_ms)`` (the fraction of observations at or under an SLO
threshold) interpolates inside the straddling bucket. Both are therefore
bucket-resolution approximations — by construction within one bucket width
(~7%) of the exact order statistic.

Thread-safety: ``observe`` is a single list increment plus two scalar adds,
each GIL-atomic — same single-writer-per-worker contract as the recorder's
counters. ``merge`` and the readers copy under the caller's lock.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

DEFAULT_LO_MS = 0.05
DEFAULT_GROWTH = 1.15
DEFAULT_BUCKETS = 128


class LatencyHistogram:
    """Log-bucketed histogram of millisecond latencies."""

    __slots__ = ("lo", "growth", "nbuckets", "counts", "n", "total_ms", "_inv_log_growth")

    def __init__(
        self,
        lo: float = DEFAULT_LO_MS,
        growth: float = DEFAULT_GROWTH,
        nbuckets: int = DEFAULT_BUCKETS,
    ):
        if lo <= 0 or growth <= 1.0 or nbuckets < 2:
            raise ValueError(f"bad histogram geometry ({lo}, {growth}, {nbuckets})")
        self.lo = float(lo)
        self.growth = float(growth)
        self.nbuckets = int(nbuckets)
        self.counts = [0] * self.nbuckets
        self.n = 0
        self.total_ms = 0.0
        self._inv_log_growth = 1.0 / math.log(self.growth)

    # ------------------------------------------------------------------ write

    def _index(self, ms: float) -> int:
        if ms <= self.lo:
            return 0
        i = int(math.log(ms / self.lo) * self._inv_log_growth)
        return min(i, self.nbuckets - 1)

    def observe(self, ms: float) -> None:
        ms = float(ms)
        if ms < 0 or ms != ms:  # negative or NaN: clock skew, drop
            return
        self.counts[self._index(ms)] += 1
        self.n += 1
        self.total_ms += ms

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s buckets into self (same geometry required)."""
        if (other.lo, other.growth, other.nbuckets) != (
            self.lo,
            self.growth,
            self.nbuckets,
        ):
            raise ValueError("cannot merge histograms with different geometry")
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.n += other.n
        self.total_ms += other.total_ms
        return self

    # ------------------------------------------------------------------- read

    def _edges(self, i: int):
        lower = self.lo * self.growth**i if i > 0 else 0.0
        upper = self.lo * self.growth ** (i + 1)
        return lower, upper

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (q in [0, 1]): the geometric midpoint of
        the bucket holding the ceil(q*n)-th observation. None when empty."""
        if self.n == 0:
            return None
        target = max(1, math.ceil(q * self.n))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                lower, upper = self._edges(i)
                return math.sqrt(max(lower, self.lo / self.growth) * upper)
        return None  # unreachable with n > 0

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    @property
    def mean_ms(self) -> Optional[float]:
        return self.total_ms / self.n if self.n else None

    def attainment(self, slo_ms: float) -> Optional[float]:
        """Fraction of observations <= ``slo_ms`` (SLO attainment), with
        linear interpolation inside the bucket the threshold lands in.
        None when empty."""
        if self.n == 0:
            return None
        slo_ms = float(slo_ms)
        idx = self._index(slo_ms)
        under = sum(self.counts[:idx])
        lower, upper = self._edges(idx)
        frac = min(1.0, max(0.0, (slo_ms - lower) / (upper - lower)))
        if slo_ms >= self.lo * self.growth**self.nbuckets:
            frac = 1.0  # past the last bucket's upper edge: everything counts
        return (under + frac * self.counts[idx]) / self.n

    # ------------------------------------------------------------- serialize

    def to_dict(self) -> Dict[str, Any]:
        """Sparse JSON-safe encoding (bucket index -> count)."""
        return {
            "lo": self.lo,
            "growth": self.growth,
            "nbuckets": self.nbuckets,
            "n": self.n,
            "total_ms": round(self.total_ms, 3),
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LatencyHistogram":
        h = cls(
            lo=float(d.get("lo", DEFAULT_LO_MS)),
            growth=float(d.get("growth", DEFAULT_GROWTH)),
            nbuckets=int(d.get("nbuckets", DEFAULT_BUCKETS)),
        )
        for k, c in (d.get("counts") or {}).items():
            i = int(k)
            if 0 <= i < h.nbuckets:
                h.counts[i] = int(c)
        h.n = int(d.get("n", sum(h.counts)))
        h.total_ms = float(d.get("total_ms", 0.0))
        return h

    def copy(self) -> "LatencyHistogram":
        h = LatencyHistogram(self.lo, self.growth, self.nbuckets)
        h.counts = list(self.counts)
        h.n = self.n
        h.total_ms = self.total_ms
        return h

    def __repr__(self) -> str:  # debugging aid
        p = self.percentiles()
        return (
            f"LatencyHistogram(n={self.n}, p50={p['p50']}, p95={p['p95']}, "
            f"p99={p['p99']})"
        )


def merge_dicts(dicts) -> Optional[LatencyHistogram]:
    """Merge an iterable of ``to_dict`` encodings (skipping None/malformed)
    into one histogram; None when nothing merged. The fleet router's
    SSTATS fold uses this on per-replica snapshots."""
    out: Optional[LatencyHistogram] = None
    for d in dicts:
        if not d:
            continue
        try:
            h = LatencyHistogram.from_dict(d)
        except (TypeError, ValueError):
            continue
        if out is None:
            out = h
        else:
            try:
                out.merge(h)
            except ValueError:
                continue
    return out
