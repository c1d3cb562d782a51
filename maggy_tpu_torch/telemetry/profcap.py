"""Alert-triggered profile capture: evidence at the moment capacity breaks.

The port's copy of :mod:`maggy_tpu.telemetry.profcap`; the device trace is
``torch.profiler``'s (CPU and CUDA activities) when the serving device is a
CUDA card, and the JSON capture is as in the JAX package.

A burn-rate page tells you *that* HBM headroom collapsed; by the time a
human attaches a profiler the episode is over. This module closes that gap:
a bounded, cooldown-limited controller that arms a profile capture the
moment a watched critical alert **transitions to firing** (the scheduler's
metrics tick feeds it the transition list ``AlertEvaluator.evaluate``
already returns), and writes the capture next to the flight-recorder dumps
under ``<exp_dir>/telemetry/profcap_<ts>_<n>/``.

What a capture holds:

* on a CUDA device, a ``torch.profiler`` trace of
  :attr:`ProfileCapture.trace_s` seconds (at most 2 s), written as
  ``trace.json`` (Chrome trace format) beside the capture: the device
  timeline of the window the alert fired in. It runs on the thread that
  ticks the controller (the scheduler's loop), which launches nothing while
  it waits: a profiler started in one thread while another thread launches
  work crashed one of five card runs of the serving smoke test;
* everywhere (and always, as the CPU-safe fallback), a flight-recorder-style
  ``capture.json``: the triggering alert, every firing alert, the recent
  samples of each alerted series (``alerted_series_tails``), and the stack
  of every thread — self-describing without any device tooling.

Bounds, because a profiler armed by an alert is a footgun: at most
:data:`MAX_CAPTURES` per process, at least :attr:`~ProfileCapture.cooldown_s`
seconds apart (a flapping alert produces ONE capture per episode, not one
per flap), and the whole controller is disabled by ``MAGGY_TPU_PROFCAP=0``.
A capture failure is swallowed — observability must never sink the loop.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

from maggy_tpu_torch.core import lockdebug

ENV_FLAG = "MAGGY_TPU_PROFCAP"
DEFAULT_COOLDOWN_S = 120.0
DEFAULT_TRACE_S = 0.5
MAX_CAPTURES = 4  # per-process cap, like flightrec.MAX_DUMPS

# critical capacity alerts that arm a capture by default; callers can widen
# or narrow per instance
DEFAULT_WATCH = ("alert.hbm_headroom", "alert.fragmentation")


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "1").lower() not in ("0", "false", "off")


class ProfileCapture:
    """Cooldown-limited alert→profile controller for one worker.

    Owned by the scheduler (or trainer) beside its :class:`AlertEvaluator`;
    :meth:`tick` runs on the owner's metrics thread with the transitions
    that thread's ``evaluate`` call just returned. State is lock-guarded so
    SSTATS readers can snapshot it from RPC threads.
    """

    def __init__(
        self,
        dump_dir: Optional[str] = None,
        env=None,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        max_captures: int = MAX_CAPTURES,
        trace_s: float = DEFAULT_TRACE_S,
        watch: Optional[Iterable[str]] = None,
        device=None,
    ):
        self._lock = lockdebug.lock("profcap._lock")
        self.dump_dir = dump_dir
        self._env = env
        self.cooldown_s = float(cooldown_s)
        self.max_captures = int(max_captures)
        self.trace_s = float(trace_s)
        self.watch = frozenset(watch if watch is not None else DEFAULT_WATCH)
        # the serving device: a CUDA one gets a torch.profiler trace
        self.device = device
        self._count = 0  # guarded-by: _lock
        self._last_ts: Optional[float] = None  # guarded-by: _lock
        self.captures: List[str] = []  # written paths  # guarded-by: _lock
        self.last_capture: Optional[Dict[str, Any]] = None

    def configure(self, dump_dir: Optional[str] = None, env=None) -> None:
        """Late wiring — the telemetry sink knows the dump dir, not us."""
        if dump_dir is not None:
            self.dump_dir = str(dump_dir)
        if env is not None:
            self._env = env

    # ------------------------------------------------------------------- tick

    def tick(self, transitions, now: Optional[float] = None) -> Optional[str]:  # thread-entry — ticked from the owning scheduler/trainer metrics loop
        """Arm a capture when a watched alert just transitioned to firing.

        ``transitions`` is whatever ``AlertEvaluator.evaluate`` returned this
        tick. Returns the capture directory path (None when nothing fired,
        disabled, in cooldown, or over the per-process cap)."""
        if not enabled() or not transitions:
            return None
        from maggy_tpu_torch.telemetry.alerts import ALERT_FIRING

        trigger = None
        for t in transitions:
            if t.get("event") == ALERT_FIRING and t.get("alert") in self.watch:
                trigger = t
                break
        if trigger is None:
            return None
        ts = time.time() if now is None else float(now)
        with self._lock:
            if self._count >= self.max_captures:
                return None
            if self._last_ts is not None and ts - self._last_ts < self.cooldown_s:
                return None
            self._last_ts = ts
            self._count += 1
            n = self._count
        try:
            return self._capture(trigger, ts, n)
        except Exception:  # noqa: BLE001 - a failed capture must not kill serving
            return None

    # ---------------------------------------------------------------- capture

    def _capture(self, trigger: Dict[str, Any], ts: float, n: int) -> Optional[str]:
        from maggy_tpu_torch.telemetry import alerts as alerts_mod
        from maggy_tpu_torch.telemetry import flightrec
        from maggy_tpu_torch.telemetry import recorder as rec_mod

        out_dir = (
            os.path.join(str(self.dump_dir), f"profcap_{int(ts)}_{n}")
            if self.dump_dir is not None
            else None
        )
        payload: Dict[str, Any] = {
            "kind": "profcap",
            "ts": ts,
            "reason": f"alert:{trigger.get('alert')}",
            "trigger": dict(trigger),
            "pid": os.getpid(),
            "profiler": self._device_trace(out_dir),
            "alerts": alerts_mod.active_alerts(),
            "alert_series": alerts_mod.alerted_series_tails(),
            "threads": flightrec.thread_stacks(),
        }
        self.last_capture = payload
        rec_mod.get().count("profcap.captures")
        if out_dir is None:
            return None
        path = os.path.join(out_dir, "capture.json")
        text = json.dumps(payload, separators=(",", ":"), default=str)
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
        except OSError:
            return None
        with self._lock:
            self.captures.append(out_dir)
        return out_dir

    def _device_trace(self, out_dir: Optional[str]) -> str:
        """Bounded ``torch.profiler`` trace when the serving device is a CUDA
        card; on the CPU (or any failure) the JSON fallback payload IS the
        capture."""
        if out_dir is None or getattr(self.device, "type", self.device) != "cuda":
            return "fallback"
        try:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(out_dir, exist_ok=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(min(self.trace_s, 2.0))
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            return "torch.profiler"
        except Exception:  # noqa: BLE001 - profiler arming is best-effort
            return "fallback"

    # ------------------------------------------------------------------ state

    def snapshot(self) -> Dict[str, Any]:
        """SSTATS-ready controller state."""
        with self._lock:
            return {
                "enabled": enabled(),
                "captures": self._count,
                "cooldown_s": self.cooldown_s,
                "max_captures": self.max_captures,
                "last_ts": self._last_ts,
                "paths": list(self.captures),
            }
