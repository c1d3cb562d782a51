"""Bounded in-memory time series over the telemetry recorder.

A copy of :mod:`maggy_tpu.telemetry.timeseries`. ``Trainer.fit`` samples its
recorder into a store on a ~1 s tick and reconciles the memory ledger on the
same tick; the serving scheduler keeps one on its metrics tick.

Everything else in ``telemetry/`` is a point-in-time snapshot: the recorder
keeps *latest* gauge values, *cumulative* counters, and *cumulative*
histograms. This module adds the time dimension — a :class:`SeriesStore`
samples a recorder on a fixed tick into bounded ring buffers, so windowed
questions ("TTFT p95 over the last 30 s", "queue-depth trend", "requests/s")
have an answer without a log scan. The fleet router keeps one store per
replica plus a fleet-aggregate store fed at the *same* tick, which is what
makes ``tools/metrics_query.py`` able to reproduce fleet percentiles from
per-replica exports: bucket-wise histogram merge commutes with windowed
subtraction when the ticks align.

Design rules, same as the recorder:

- Lock-free hot path. Appends are single-writer (the sampling thread);
  readers copy via ``list(deque)`` which is atomic under the GIL.
- Histogram series store *cumulative* ``LatencyHistogram.to_dict()``
  encodings per tick. A windowed distribution is the bucket-wise difference
  between the newest snapshot and the last snapshot at-or-before the window
  start — O(buckets), no samples retained.
- Counters are cumulative too; ``delta()``/``rate()`` difference the ring.
  A counter reset (process restart) clamps to zero rather than going
  negative.

The serialized form (:meth:`SeriesStore.snapshot`) is versioned so exported
snapshots stay readable across PRs.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .histogram import LatencyHistogram, merge_dicts

SCHEMA_VERSION = 1

DEFAULT_CAPACITY = 512  # points per series ring
DEFAULT_INTERVAL_S = 1.0  # sampling tick

KINDS = ("gauge", "counter", "hist")


def hist_delta(
    newer: Optional[Dict[str, Any]], older: Optional[Dict[str, Any]]
) -> Optional[LatencyHistogram]:
    """Bucket-wise ``newer - older`` of two cumulative ``to_dict`` encodings.

    Returns the distribution of observations that happened *between* the two
    snapshots. ``older=None`` means "since the beginning" (newer as-is).
    Negative buckets (histogram reset) clamp to zero. Geometry mismatch —
    impossible for snapshots of one series, conceivable across restarts —
    falls back to ``newer``.
    """
    if not newer:
        return None
    try:
        h = LatencyHistogram.from_dict(newer)
    except (TypeError, ValueError):
        return None
    if not older:
        return h
    try:
        o = LatencyHistogram.from_dict(older)
    except (TypeError, ValueError):
        return h
    if (o.lo, o.growth, o.nbuckets) != (h.lo, h.growth, h.nbuckets):
        return h
    for i, c in enumerate(o.counts):
        if c:
            h.counts[i] = max(0, h.counts[i] - c)
    h.n = max(0, h.n - o.n)
    h.total_ms = max(0.0, h.total_ms - o.total_ms)
    return h


class Series:
    """One named metric over time: a bounded ring of ``(ts, value)`` points.

    ``kind`` is ``"gauge"`` (point-in-time value), ``"counter"`` (cumulative
    total; query via ``delta``/``rate``), or ``"hist"`` (cumulative
    ``LatencyHistogram.to_dict()`` encoding; query via
    ``percentile``/``attainment`` over a window).
    """

    __slots__ = ("name", "kind", "_points")

    def __init__(self, name: str, kind: str, capacity: int = DEFAULT_CAPACITY):
        if kind not in KINDS:
            raise ValueError(f"unknown series kind {kind!r}")
        self.name = name
        self.kind = kind
        self._points: deque = deque(maxlen=max(2, int(capacity)))

    # ------------------------------------------------------------------ write

    def append(self, ts: float, value: Any) -> None:
        self._points.append((ts, value))

    # ------------------------------------------------------------------- read

    def __len__(self) -> int:
        return len(self._points)

    def points(self) -> List[Tuple[float, Any]]:
        return list(self._points)

    def latest(self) -> Optional[Tuple[float, Any]]:
        pts = self._points
        return pts[-1] if pts else None

    def tail(self, n: int) -> List[Tuple[float, Any]]:
        pts = list(self._points)
        return pts[-int(n):] if n else []

    def window(self, window_s: float, now: Optional[float] = None) -> List[Tuple[float, Any]]:
        """Points with ``ts >= now - window_s`` (oldest first)."""
        pts = list(self._points)
        if not pts:
            return []
        cutoff = (now if now is not None else pts[-1][0]) - window_s
        return [p for p in pts if p[0] >= cutoff]

    def _bounds(
        self, window_s: float, now: Optional[float] = None
    ) -> Tuple[Optional[Tuple[float, Any]], Optional[Tuple[float, Any]]]:
        """(base, last) spanning the window: ``base`` is the newest point
        at-or-before the window start (so the difference covers the full
        window), or None when the ring doesn't reach back that far — then
        the caller differences against the oldest retained point."""
        pts = list(self._points)
        if not pts:
            return None, None
        last = pts[-1]
        cutoff = (now if now is not None else last[0]) - window_s
        base = None
        for p in pts:
            if p[0] <= cutoff:
                base = p
            else:
                break
        return base, last

    # ------------------------------------------------- windowed queries

    def delta(self, window_s: float, now: Optional[float] = None) -> Optional[float]:
        """Increase of a cumulative series over the window (clamped >= 0)."""
        base, last = self._bounds(window_s, now)
        if last is None:
            return None
        if base is None:
            pts = list(self._points)
            if len(pts) < 2:
                return None
            base = pts[0]
        return max(0.0, float(last[1]) - float(base[1]))

    def rate(self, window_s: float, now: Optional[float] = None) -> Optional[float]:
        """Per-second increase over the window (counter kind)."""
        base, last = self._bounds(window_s, now)
        if last is None:
            return None
        if base is None:
            pts = list(self._points)
            if len(pts) < 2:
                return None
            base = pts[0]
        elapsed = last[0] - base[0]
        if elapsed <= 0:
            return None
        return max(0.0, float(last[1]) - float(base[1])) / elapsed

    def window_hist(
        self, window_s: float, now: Optional[float] = None
    ) -> Optional[LatencyHistogram]:
        """Distribution of observations inside the window (hist kind)."""
        base, last = self._bounds(window_s, now)
        if last is None:
            return None
        return hist_delta(last[1], base[1] if base is not None else None)

    def percentile(
        self, q: float, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        h = self.window_hist(window_s, now)
        return h.percentile(q) if h is not None else None

    def attainment(
        self, slo_ms: float, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        h = self.window_hist(window_s, now)
        return h.attainment(slo_ms) if h is not None else None

    def values(self, n: int = 16) -> List[float]:
        """Last ``n`` numeric values for trend display. Counters come back as
        successive differences (per-tick increments), hist as per-point n."""
        pts = self.tail(n + 1 if self.kind == "counter" else n)
        if self.kind == "gauge":
            return [float(v) for _, v in pts]
        if self.kind == "counter":
            vals = [float(v) for _, v in pts]
            return [max(0.0, b - a) for a, b in zip(vals, vals[1:])]
        out = []
        for _, v in pts:
            out.append(float((v or {}).get("n", 0)))
        return out

    # -------------------------------------------------------------- serialize

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "points": [[ts, v] for ts, v in self._points]}

    @classmethod
    def from_dict(cls, name: str, d: Dict[str, Any], capacity: int = DEFAULT_CAPACITY) -> "Series":
        s = cls(name, str(d.get("kind", "gauge")), capacity)
        for ts, v in d.get("points") or []:
            s.append(float(ts), v)
        return s


class SeriesStore:
    """A keyed set of :class:`Series` plus the sampling tick that feeds them.

    One store per scope: each worker's scheduler owns one (fed from its
    recorder), and the fleet router owns one per replica plus a
    fleet-aggregate store fed at the same tick.
    """

    def __init__(
        self,
        interval_s: float = DEFAULT_INTERVAL_S,
        capacity: int = DEFAULT_CAPACITY,
    ):
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        # single-writer per store: only the owner's metrics tick (scheduler
        # decode thread / router pump) appends; RPC-side readers copy via
        # list() and tolerate a tick of staleness
        self._series: Dict[str, Series] = {}  # race: ok — single-writer (owner tick); GIL-atomic dict stores; readers snapshot via list()
        self._last_sample = 0.0  # race: ok — single-writer tick gate; a stale read costs one extra compare

    # ------------------------------------------------------------------ write

    def series(self, name: str, kind: str) -> Series:
        s = self._series.get(name)
        if s is None or s.kind != kind:
            s = Series(name, kind, self.capacity)
            self._series[name] = s
        return s

    def ingest(  # thread-entry — the router pump / scheduler metrics threads feed ticks
        self,
        ts: float,
        gauges: Optional[Dict[str, float]] = None,
        counters: Optional[Dict[str, float]] = None,
        hists: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> None:
        """Append one aligned tick of externally-sourced values (the router
        feeds replica SSTATS through this)."""
        for name, v in (gauges or {}).items():
            if v is not None:
                self.series(name, "gauge").append(ts, float(v))
        for name, v in (counters or {}).items():
            if v is not None:
                self.series(name, "counter").append(ts, float(v))
        for name, d in (hists or {}).items():
            if d:
                self.series(name, "hist").append(ts, dict(d))

    def sample(self, recorder, now: Optional[float] = None) -> float:  # thread-entry — called from the scheduler's decode-loop tick
        """Copy the recorder's current gauges/counters/histograms into the
        rings as one tick. Cheap: dict copies + one ``to_dict`` per live
        histogram; the recorder's single-writer/GIL-atomic contract makes
        the reads safe without locks."""
        ts = now if now is not None else time.time()
        gauges = dict(getattr(recorder, "_gauges", None) or {})
        counters = dict(getattr(recorder, "_counters", None) or {})
        hists = dict(getattr(recorder, "_hists", None) or {})
        self.ingest(
            ts,
            gauges=gauges,
            counters=counters,
            hists={k: h.to_dict() for k, h in hists.items()},
        )
        self._last_sample = ts
        return ts

    def maybe_sample(self, recorder, now: Optional[float] = None) -> bool:
        """Tick-gated :meth:`sample`; the per-call cost when it's not time
        yet is one clock read and a compare."""
        ts = now if now is not None else time.time()
        if ts - self._last_sample < self.interval_s:
            return False
        self.sample(recorder, ts)
        return True

    # ------------------------------------------------------------------- read

    def get(self, name: str) -> Optional[Series]:
        return self._series.get(name)

    def names(self) -> List[str]:
        return sorted(self._series)

    def trends(self, names: Iterable[str], n: int = 16) -> Dict[str, List[float]]:
        """Compact recent-values map for sparkline rendering."""
        out: Dict[str, List[float]] = {}
        for name in names:
            s = self._series.get(name)
            if s is not None and len(s):
                vals = s.values(n)
                if vals:
                    out[name] = [round(v, 3) for v in vals]
        return out

    # -------------------------------------------------------------- serialize

    def snapshot(self) -> Dict[str, Any]:
        """Versioned JSON-safe encoding of every series (the METRICS verb
        payload and the on-disk export form)."""
        return {
            "v": SCHEMA_VERSION,
            "interval_s": self.interval_s,
            "series": {name: s.to_dict() for name, s in list(self._series.items())},
        }

    @classmethod
    def from_snapshot(cls, d: Dict[str, Any]) -> "SeriesStore":
        v = int(d.get("v", 0))
        if v > SCHEMA_VERSION:
            raise ValueError(f"timeseries snapshot v{v} newer than supported v{SCHEMA_VERSION}")
        store = cls(interval_s=float(d.get("interval_s", DEFAULT_INTERVAL_S)))
        for name, sd in (d.get("series") or {}).items():
            store._series[name] = Series.from_dict(name, sd, store.capacity)
        return store


def merge_windowed_hist(
    stores: Iterable[SeriesStore],
    name: str,
    window_s: float,
    now: Optional[float] = None,
) -> Optional[LatencyHistogram]:
    """Fleet merge of one histogram series: sum of each store's windowed
    distribution. Because bucket addition commutes with the windowed
    subtraction, this equals the router's fleet-aggregate series (which
    appends the bucket-wise merge of per-replica cumulative snapshots at
    the same tick) queried over the same window."""
    parts = []
    for store in stores:
        s = store.get(name)
        if s is None or s.kind != "hist":
            continue
        h = s.window_hist(window_s, now)
        if h is not None:
            parts.append(h.to_dict())
    return merge_dicts(parts)


def merge_windowed_percentile(
    stores: Iterable[SeriesStore],
    name: str,
    q: float,
    window_s: float,
    now: Optional[float] = None,
) -> Optional[float]:
    h = merge_windowed_hist(stores, name, window_s, now)
    return h.percentile(q) if h is not None else None
