"""Process-local telemetry recorder.

One :class:`Telemetry` instance per worker (executor thread, pod process, or
the driver itself). The hot path — ``span`` enter/exit, ``gauge``,
``event``, ``histogram`` — touches only ``deque.append``s and dict stores,
each a single GIL-atomic operation, so per-worker recording is lock-free;
the only lock in the class guards the RPC latency accumulators, which sit
on network-bound paths where a ~100ns uncontended acquire is noise.

Every record is tagged with the thread-ambient trace id
(:mod:`maggy_tpu_torch.telemetry.tracing`) when one is in scope, and teed into a
bounded flight ring the stall watchdog
(:mod:`maggy_tpu_torch.telemetry.flightrec`) dumps when a progress loop wedges.
``histogram`` aggregates latency samples into fixed-log-bucket
distributions (:mod:`maggy_tpu_torch.telemetry.histogram`) that ride in
snapshots — mergeable across workers, percentile-ready.

Two clocks, deliberately: every record carries a wall-clock ``ts``
(``time.time()``, the common base that lets the exporter merge spans from
many workers/hosts into one Chrome trace) while durations come from
``time.perf_counter()`` (monotonic, immune to NTP steps).

``MAGGY_TPU_TELEMETRY=0`` disables recording globally: :func:`get` then
returns the shared :data:`NULL` no-op recorder, whose ``span`` hands back one
reusable null context manager — the instrumented code paths stay in place at
zero cost.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from maggy_tpu_torch.core import lockdebug
from maggy_tpu_torch.telemetry import tracing
from maggy_tpu_torch.telemetry.histogram import LatencyHistogram

ENV_FLAG = "MAGGY_TPU_TELEMETRY"

# span/gauge events kept in memory between sink flushes; oldest dropped first
# (a worker with an attached sink flushes every heartbeat, so the cap only
# matters for unflushed standalone use)
DEFAULT_CAPACITY = 100_000

# flight-recorder ring: the last records this worker produced, always in
# memory, dumped by the stall watchdog (telemetry/flightrec.py)
FLIGHT_CAPACITY = 512


def enabled() -> bool:
    """Telemetry is on unless explicitly disabled (``MAGGY_TPU_TELEMETRY=0``)."""
    return os.environ.get(ENV_FLAG, "1").lower() not in ("0", "false", "off")


class Telemetry:
    """Recorder for one worker: spans, gauges, counters, RPC latencies."""

    active = True

    def __init__(self, worker: Any = 0, role: str = "worker", capacity: int = DEFAULT_CAPACITY):
        self.worker = str(worker)
        self.role = role
        self._events: deque = deque(maxlen=capacity)
        # bounded tee of the same records for the stall flight recorder —
        # never drained, so a dump always has the recent past
        self.flight: deque = deque(maxlen=FLIGHT_CAPACITY)
        self._gauges: Dict[str, float] = {}  # race: ok — GIL-atomic dict stores, latest-value-wins semantics; snapshot copies are best-effort
        self._counters: Dict[str, int] = {}  # race: ok — single-writer per key by design (module docstring); rpc_errors.* keys are written only under _rpc_lock
        # name -> fixed-log-bucket latency distribution (single-writer per
        # worker, like counters; snapshot copies under no lock by the same
        # GIL-atomicity argument)
        self._hists: Dict[str, LatencyHistogram] = {}
        # verb -> [n, total_ms, max_ms]; the single locked structure (see
        # module docstring) because two threads (worker + heartbeat) write it
        self._rpc: Dict[str, List[float]] = {}
        self._rpc_lock = lockdebug.lock("telemetry._rpc_lock")
        self._sink = None
        # flush is called from both the worker thread (trial boundaries) and
        # the heartbeat thread (per beat); serialize so JSONL lines never tear
        self._flush_lock = lockdebug.lock("telemetry._flush_lock")
        _instances.add(self)

    # ------------------------------------------------------------------ spans

    def _append(self, rec: Dict[str, Any]) -> None:
        """Journal one record (sink buffer + flight ring), tagging it with
        the thread-ambient trace id when one is in scope — the whole
        cross-worker correlation story is this one optional field."""
        trace = tracing.current()
        if trace is not None:
            rec["trace"] = trace
        self._events.append(rec)
        self.flight.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        """Time a block; records wall-clock start + duration on exit."""
        ts = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = {
                "kind": "span",
                "name": name,
                "ts": ts,
                "dur_ms": (time.perf_counter() - t0) * 1e3,
                "worker": self.worker,
                "tid": threading.get_ident() & 0xFFFF,
            }
            if attrs:
                rec["attrs"] = attrs
            self._append(rec)

    # ------------------------------------------------------- gauges / counters

    def gauge(self, name: str, value: float) -> None:  # thread-entry — heartbeat + scheduler threads record gauges
        """Set a gauge to its latest value (also journaled as an event)."""
        value = float(value)
        self._gauges[name] = value
        self._append(
            {
                "kind": "gauge",
                "name": name,
                "ts": time.time(),
                "value": value,
                "worker": self.worker,
            }
        )

    def count(self, name: str, n: int = 1) -> None:  # thread-entry — scheduler/router threads count from their loops
        """Increment a counter (single-writer per worker by design)."""
        self._counters[name] = self._counters.get(name, 0) + n

    def event(self, name: str, trace: Optional[str] = None, **attrs) -> None:
        """Journal one lifecycle milestone (request/run state transition),
        correlated by ``trace`` (explicit, else the thread-ambient id)."""
        rec: Dict[str, Any] = {
            "kind": "event",
            "name": name,
            "ts": time.time(),
            "worker": self.worker,
        }
        if attrs:
            rec["attrs"] = attrs
        if trace is not None:
            rec["trace"] = trace
            self._events.append(rec)
            self.flight.append(rec)
        else:
            self._append(rec)

    def histogram(self, name: str, value_ms: float) -> None:
        """Observe one latency sample into the named fixed-log-bucket
        histogram (created on first use; serialized into snapshots)."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists.setdefault(name, LatencyHistogram())
        h.observe(value_ms)

    def rpc(self, verb: str, ms: Optional[float] = None, ok: bool = True) -> None:  # thread-entry — worker + heartbeat threads both record RPCs
        """Record one RPC round-trip for ``verb`` (thread-safe)."""
        with self._rpc_lock:
            rec = self._rpc.setdefault(verb, [0, 0.0, 0.0])
            rec[0] += 1
            if ms is not None:
                rec[1] += ms
                if ms > rec[2]:
                    rec[2] = ms
            if not ok:
                self._counters[f"rpc_errors.{verb}"] = (
                    self._counters.get(f"rpc_errors.{verb}", 0) + 1
                )

    # ------------------------------------------------------------------ export

    def snapshot(self) -> Dict[str, Any]:  # thread-entry — the heartbeat thread attaches snapshots to beats
        """Compact aggregate state for heartbeat attachment: latest gauges,
        counters, and per-verb RPC stats — no event history."""
        out: Dict[str, Any] = {"worker": self.worker, "role": self.role, "ts": time.time()}
        if self._gauges:
            out["gauges"] = dict(self._gauges)
        if self._counters:
            out["counters"] = dict(self._counters)
        if self._hists:
            out["hist"] = {name: h.to_dict() for name, h in self._hists.items()}
        with self._rpc_lock:
            if self._rpc:
                out["rpc"] = {
                    verb: {
                        "n": int(n),
                        "mean_ms": round(total / n, 3) if n else None,
                        "max_ms": round(mx, 3),
                    }
                    for verb, (n, total, mx) in self._rpc.items()
                }
        return out

    def drain_events(self) -> List[Dict[str, Any]]:
        """Pop and return all buffered events (safe against concurrent appends)."""
        out = []
        try:
            while True:
                out.append(self._events.popleft())
        except IndexError:
            pass
        return out

    # ------------------------------------------------------------------- sink

    def attach_sink(self, sink) -> None:
        self._sink = sink

    def flush(self) -> None:  # thread-entry — the heartbeat thread flushes every beat
        """Drain buffered events into the attached sink (no-op without one)."""
        if self._sink is None:
            return
        with self._flush_lock:
            if self._sink is None:
                return
            events = self.drain_events()
            if events:
                self._sink.write(events)

    def close(self) -> None:
        """Final flush + snapshot record, then close the sink."""
        if self._sink is None:
            return
        snap = self.snapshot()
        snap["kind"] = "snapshot"
        self._events.append(snap)
        self.flush()
        with self._flush_lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None


class NullTelemetry:
    """No-op recorder installed when telemetry is disabled."""

    active = False
    worker = "null"
    role = "null"

    _NULL_CTX = contextlib.nullcontext()

    def span(self, name: str, **attrs):
        return self._NULL_CTX

    def gauge(self, name: str, value: float) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass

    def event(self, name: str, trace: Optional[str] = None, **attrs) -> None:
        pass

    def histogram(self, name: str, value_ms: float) -> None:
        pass

    def rpc(self, verb: str, ms: Optional[float] = None, ok: bool = True) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def drain_events(self) -> List[Dict[str, Any]]:
        return []

    def attach_sink(self, sink) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullTelemetry()

# every live recorder, for the stall watchdog's dump (weak: a recorder dies
# with its owner, the registry must not keep it alive)
_instances: "weakref.WeakSet[Telemetry]" = weakref.WeakSet()


def flight_snapshots() -> List[Dict[str, Any]]:
    """Every live recorder's flight ring (most recent records last), for
    the watchdog dump. Rings are copied, never drained."""
    out = []
    for tel in list(_instances):
        ring = list(tel.flight)
        if ring:
            out.append({"worker": tel.worker, "role": tel.role, "events": ring})
    return out


# thread-ambient recorder: executors are THREADS in one process (like the
# Reporter print tee), so the current recorder is thread-local, with one lazy
# process-wide default for standalone Trainer.fit use outside any experiment
_tls = threading.local()
_default_lock = threading.Lock()
_default: Optional[Telemetry] = None


def get():
    """The ambient recorder for this thread; :data:`NULL` when disabled."""
    if not enabled():
        return NULL
    tel = getattr(_tls, "telemetry", None)
    if tel is not None:
        return tel
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Telemetry(worker="main", role="standalone")
    return _default


def set_current(tel) -> None:
    """Install ``tel`` as this thread's ambient recorder (None to clear)."""
    _tls.telemetry = tel


@contextlib.contextmanager
def current(tel) -> Iterator[None]:
    """Scope ``tel`` as the ambient recorder for this thread."""
    prev = getattr(_tls, "telemetry", None)
    _tls.telemetry = tel
    try:
        yield
    finally:
        _tls.telemetry = prev
