"""Stall watchdog + flight recorder: evidence when a worker stops moving.

A hung replica, a wedged RPC event loop, or a stalled train-step loop dies
silently today: the process is alive, heartbeats may even flow, but no
progress happens and nothing records *what it was doing when it stopped*.
This module fixes both halves:

* **Flight recorder.** Every :class:`~maggy_tpu_torch.telemetry.recorder.Telemetry`
  tees its records (spans, gauges, lifecycle events) into a small bounded
  ring — the last ~512 things the worker did, always in memory, costing one
  ``deque.append`` per record. Nothing is written anywhere until a stall.
* **Stall watchdog.** Code that owns a progress loop *arms a mark*
  (``begin(name)``), then ``beat(name)`` every iteration and ``end(name)``
  on exit. One daemon thread (lazily started on the first ``begin``) scans
  the marks; a mark that is armed but has not beaten for ``stall_s``
  seconds triggers a **dump**: every live recorder's event ring, the mark
  table, and the stack of every thread in the process, written to
  ``<dump_dir>/flightrec_<ts>_<n>.json`` (``<exp_dir>/telemetry/`` when the
  worker telemetry sink configured it) and kept at :attr:`Watchdog.last_dump`.

Armed marks (instrumented in this PR): ``rpc.<verb>`` around every server
dispatch (covers the chaos ``rpc_stall`` seam — the injected stall holds the
event loop exactly like a wedged driver host), ``serve.loop`` around the
serving scheduler's engine loop, and ``train.step`` around ``Trainer.fit``'s
step loop. A mark dumps once per stall episode (re-armed by its next beat),
and dumps are capped per process.

Env knobs: ``MAGGY_TPU_FLIGHTREC=0`` disables the watchdog entirely (a
shared no-op stands in, so call sites stay unconditional);
``MAGGY_TPU_STALL_S`` sets the stall threshold (default 60 s — far above any
healthy beat cadence, low enough to catch a genuinely wedged loop).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

ENV_FLAG = "MAGGY_TPU_FLIGHTREC"
ENV_STALL = "MAGGY_TPU_STALL_S"
DEFAULT_STALL_S = 60.0
MAX_DUMPS = 16  # per-process cap so a flapping stall can't fill a disk


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "1").lower() not in ("0", "false", "off")


def default_stall_s() -> float:
    try:
        return float(os.environ[ENV_STALL])
    except (KeyError, ValueError):
        return DEFAULT_STALL_S


def thread_stacks() -> Dict[str, List[str]]:
    """Formatted stack of every live thread, keyed ``name(ident)``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, 'thread')}({ident})"
        out[key] = traceback.format_stack(frame)
    return out


class Watchdog:
    """Progress-mark table + scanner thread + dump writer."""

    def __init__(
        self,
        stall_s: Optional[float] = None,
        interval_s: Optional[float] = None,
        dump_dir: Optional[str] = None,
        env=None,
    ):
        self.stall_s = default_stall_s() if stall_s is None else float(stall_s)
        self.interval_s = (
            max(0.05, min(1.0, self.stall_s / 4))
            if interval_s is None
            else float(interval_s)
        )
        self.dump_dir = dump_dir
        self._env = env
        # name -> {"beat": ts, "busy": int, "detail": ..., "dumped": bool}
        self._marks: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_dump: Optional[Dict[str, Any]] = None
        self.dumps: List[str] = []  # written file paths, in order

    # ----------------------------------------------------------- mark surface

    def configure(
        self, dump_dir: Optional[str] = None, env=None, stall_s: Optional[float] = None
    ) -> None:
        """Late wiring (the telemetry sink knows the dump dir, not us)."""
        if dump_dir is not None:
            self.dump_dir = str(dump_dir)
        if env is not None:
            self._env = env
        if stall_s is not None:
            self.stall_s = float(stall_s)
            self.interval_s = max(0.05, min(1.0, self.stall_s / 4))

    def begin(self, name: str, detail: Any = None) -> None:
        """Arm ``name``: progress is now expected until :meth:`end`."""
        with self._lock:
            m = self._marks.setdefault(
                name, {"beat": 0.0, "busy": 0, "detail": None, "dumped": False}
            )
            m["busy"] += 1
            m["beat"] = time.time()
            m["detail"] = detail
            m["dumped"] = False
        self._ensure_thread()

    def beat(self, name: str, detail: Any = None) -> None:
        """Record one unit of progress on an armed mark."""
        with self._lock:
            m = self._marks.get(name)
            if m is None:
                return
            m["beat"] = time.time()
            if detail is not None:
                m["detail"] = detail
            m["dumped"] = False

    def end(self, name: str) -> None:
        """Disarm one :meth:`begin` (nested begins stay armed until paired)."""
        with self._lock:
            m = self._marks.get(name)
            if m is None:
                return
            m["busy"] = max(0, m["busy"] - 1)
            m["beat"] = time.time()

    def marks(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._marks.items()}

    # ---------------------------------------------------------------- scanner

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="maggy-watchdog", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            now = time.time()
            stalled: List[str] = []
            with self._lock:
                for name, m in self._marks.items():
                    if (
                        m["busy"] > 0
                        and not m["dumped"]
                        and now - m["beat"] > self.stall_s
                    ):
                        m["dumped"] = True  # once per stall episode
                        stalled.append(name)
            for name in stalled:
                self.dump(f"stall: no progress on {name!r} for >{self.stall_s}s")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)
            self._thread = None

    # ------------------------------------------------------------------- dump

    def dump(self, reason: str) -> Optional[str]:
        """Write a flight-recorder dump; returns the path (None when the
        per-process cap is hit or no dump dir is configured — the payload is
        still kept at :attr:`last_dump` for in-process consumers)."""
        from maggy_tpu_torch.telemetry import recorder as rec_mod

        payload: Dict[str, Any] = {
            "kind": "flightrec",
            "ts": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "marks": self.marks(),
            "events": rec_mod.flight_snapshots(),
            "threads": thread_stacks(),
        }
        # embed the firing alert set and the recent samples of the metrics
        # those alerts name, so a stall dump is self-describing
        try:
            from maggy_tpu_torch.telemetry import alerts as alerts_mod

            payload["alerts"] = alerts_mod.active_alerts()
            payload["alert_series"] = alerts_mod.alerted_series_tails()
        except Exception:
            payload["alerts"] = []
            payload["alert_series"] = {}
        self.last_dump = payload
        rec_mod.get().count("flightrec.dumps")
        if self.dump_dir is None or len(self.dumps) >= MAX_DUMPS:
            return None
        name = f"flightrec_{int(payload['ts'])}_{len(self.dumps)}.json"
        path = os.path.join(str(self.dump_dir), name)
        text = json.dumps(payload, separators=(",", ":"), default=str)
        try:
            if self._env is not None:
                self._env.dump(text, path)
            else:
                os.makedirs(str(self.dump_dir), exist_ok=True)
                with open(path, "w", encoding="utf-8") as f:
                    f.write(text)
        except OSError:
            return None
        self.dumps.append(path)
        return path


class NullWatchdog:
    """No-op stand-in when ``MAGGY_TPU_FLIGHTREC=0``."""

    last_dump = None
    dumps: List[str] = []

    def configure(self, *a, **kw) -> None:
        pass

    def begin(self, name: str, detail: Any = None) -> None:
        pass

    def beat(self, name: str, detail: Any = None) -> None:
        pass

    def end(self, name: str) -> None:
        pass

    def marks(self) -> Dict[str, Any]:
        return {}

    def dump(self, reason: str) -> None:
        return None

    def stop(self) -> None:
        pass


NULL = NullWatchdog()

_lock = threading.Lock()
_active: Optional[Watchdog] = None


def get():
    """The process-wide watchdog (lazily built; :data:`NULL` when disabled)."""
    global _active
    if not enabled():
        return NULL
    if _active is None:
        with _lock:
            if _active is None:
                _active = Watchdog()
    return _active


def install(wd: Optional[Watchdog]) -> None:
    """Install a specific watchdog (tests); None restores lazy default."""
    global _active
    with _lock:
        prev, _active = _active, wd
    if prev is not None and prev is not wd:
        prev.stop()


def reset() -> None:
    install(None)
