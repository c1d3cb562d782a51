"""Worker-side metric/log reporter.

Capability parity with the reference ``maggy/core/reporter.py`` (reporter.py:30-170):
a thread-safe store that the user's ``train_fn`` broadcasts metrics into, that the
heartbeat thread drains toward the driver, and that turns a driver-issued STOP into an
``EarlyStopException`` raised at the next ``broadcast()`` call — the mechanism that
lets early stopping interrupt a Python-level training loop between jitted steps
(SURVEY.md §7 "Early stopping inside jitted training loops").
"""

from __future__ import annotations

import builtins
import contextlib
import threading
from typing import Any, List, Optional

import numpy as np

from maggy_tpu_torch import exceptions

# ---------------------------------------------------------------- print capture
#
# Reference parity: the trial executor hijacks ``print`` so a train_fn's
# prints ship to the driver with the heartbeat logs
# (trial_executor.py:93-103). The reference swaps builtins.print per Spark
# task PROCESS; our executors are THREADS in one process, so the tee is
# installed once and routes through a thread-local — concurrent trials
# capture into their own reporters without racing on builtins.

_print_local = threading.local()
_tee_lock = threading.Lock()
_active_captures = 0
_saved_print = None  # whatever print was when the tee went in (install time)
# recursion-proof fallback if a foreign hook holds a stale tee reference
_builtin_print = builtins.print


def _tee_print(*args, **kwargs):
    # reentrancy guard: if a foreign wrapper captured a stale tee reference
    # and a NEW capture saved that wrapper as _saved_print, the chain
    # tee -> wrapper -> stale tee would recurse forever without this
    if getattr(_print_local, "in_tee", False):
        _builtin_print(*args, **kwargs)
        return
    _print_local.in_tee = True
    try:
        reporter = getattr(_print_local, "reporter", None)
        if reporter is not None and kwargs.get("file") is None:
            try:
                reporter.log(
                    kwargs.get("sep", " ").join(str(a) for a in args), verbose=False
                )
            except Exception:  # noqa: BLE001 - printing must never raise
                pass
        (_saved_print or _builtin_print)(*args, **kwargs)
    finally:
        _print_local.in_tee = False


@contextlib.contextmanager
def capture_prints(reporter: "Reporter"):
    """Route this thread's ``print()`` calls into ``reporter.log`` (they
    still reach stdout). Used around train_fn execution.

    Scope note vs the reference's process-wide swap: only THIS thread's
    prints are captured — threads a train_fn spawns itself (data loaders,
    callbacks) go to stdout only. That's the price of running executors as
    threads in one process; spawned workers should log via ``reporter``.

    Install/uninstall is reference-counted: the tee wraps whatever
    ``builtins.print`` is when the FIRST capture enters (so a hook installed
    before us keeps working), and ``builtins.print`` is restored when the
    LAST capture exits — unless someone wrapped the tee in the meantime, in
    which case their chain is left untouched."""
    global _active_captures, _saved_print
    with _tee_lock:
        if _active_captures == 0:
            _saved_print = builtins.print
            builtins.print = _tee_print
        _active_captures += 1
    prev = getattr(_print_local, "reporter", None)
    _print_local.reporter = reporter
    try:
        yield
    finally:
        _print_local.reporter = prev
        with _tee_lock:
            _active_captures -= 1
            if _active_captures == 0 and builtins.print is _tee_print:
                # only on an ACTUAL restore: if a foreign hook wrapped the
                # tee we leave their chain alone — including _saved_print,
                # which the orphaned tee still forwards through (dropping it
                # would silently bypass any hook installed before us)
                builtins.print = _saved_print
                _saved_print = None


class Reporter:
    """Thread-safe metric and log buffer for one executor."""

    def __init__(self, log_file: Optional[str] = None, partition_id: int = 0, print_hook=None):
        self._lock = threading.RLock()
        self._metric: Optional[float] = None
        self._step: int = -1
        self._early_stop = False
        self._logs: List[str] = []
        self._log_file = log_file
        # remote roots (gs://, memory://): object stores can't append, so
        # buffer the whole log and publish once at close() via the env seam
        self._remote_log = bool(log_file) and "://" in str(log_file)
        self._log_history: List[str] = []
        self._remote_truncated = 0
        self._remote_logged = 0
        # publish sequencing: snapshots are taken under self._lock but
        # DUMPED outside it (network IO must not stall broadcasts); the seq
        # guard stops a preempted older snapshot from overwriting a newer one
        self._publish_lock = threading.Lock()
        self._publish_seq = 0
        self._published_seq = 0
        self._remote_closed = False
        self._log_fd = (
            open(log_file, "a", buffering=1)
            if log_file and not self._remote_log
            else None
        )
        self.partition_id = partition_id
        self.trial_id: Optional[str] = None
        self._print_hook = print_hook

    # ------------------------------------------------------------------ metrics

    def broadcast(self, metric: Any, step: Optional[int] = None) -> None:
        """Record a metric observation for the current trial.

        Validates metric and step types, enforces monotonically increasing steps,
        and raises :class:`EarlyStopException` when the driver flagged this trial
        (reference reporter.py:77-101).
        """
        with self._lock:
            if not isinstance(metric, (int, float, np.number)) or isinstance(metric, bool):
                raise exceptions.BroadcastMetricTypeError(metric)
            if step is not None and (not isinstance(step, (int, np.integer)) or isinstance(step, bool)):
                raise exceptions.BroadcastStepTypeError(metric, step)
            if step is None:
                step = self._step + 1
            step = int(step)
            if step <= self._step:
                raise exceptions.BroadcastStepValueError(metric, step, self._step)
            self._metric = float(metric)
            self._step = step
            if self._early_stop:
                # The flag stays set (cleared only by reset()) so a train_fn that
                # swallows the exception keeps being interrupted at every broadcast.
                raise exceptions.EarlyStopException(metric=self._metric)

    def get_data(self):
        """Drain pending logs and return ``(trial_id, metric, step, logs)`` for a
        heartbeat (reference reporter.py:137-142). One atomic read: trial_id and
        metric/step must come from the same trial, or a beat racing a trial
        boundary would attribute the old trial's metrics to the new one."""
        with self._lock:
            logs, self._logs = self._logs, []
            return self.trial_id, self._metric, self._step, logs

    def get_metric(self):
        with self._lock:
            return self._metric

    # ------------------------------------------------------------------ early stop

    def early_stop(self) -> None:
        with self._lock:
            self._early_stop = True

    def reset(self, trial_id: Optional[str] = None) -> None:
        """Reset per-trial state before a new trial starts (reference reporter.py:56-74)."""
        with self._lock:
            self._metric = None
            self._step = -1
            self._early_stop = False
            self.trial_id = trial_id

    # ------------------------------------------------------------------ logging

    # object stores can't append: the remote log republishes the accumulated
    # buffer every _REMOTE_FLUSH_EVERY lines (so a crashed executor loses at
    # most one window, not the whole log) and caps memory at
    # _REMOTE_MAX_LINES with an explicit truncation notice
    _REMOTE_FLUSH_EVERY = 256
    _REMOTE_MAX_LINES = 20_000

    def log(self, message: str, verbose: bool = True) -> None:
        """Buffer a log line for shipping to the driver; optionally echo locally."""
        line = str(message)
        snapshot = None
        with self._lock:
            self._logs.append(line)
            if self._log_fd:
                self._log_fd.write(line.rstrip("\n") + "\n")
            elif self._remote_log and not self._remote_closed:
                self._log_history.append(line.rstrip("\n"))
                self._remote_logged += 1  # monotonic: the capped buffer's
                # length pins at MAX_LINES, which would otherwise stop the
                # periodic flush condition from ever firing again
                if len(self._log_history) > self._REMOTE_MAX_LINES:
                    dropped = len(self._log_history) - self._REMOTE_MAX_LINES
                    self._log_history = self._log_history[dropped:]
                    self._remote_truncated += dropped
                if self._remote_logged % self._REMOTE_FLUSH_EVERY == 0:
                    snapshot = self._remote_snapshot()
        if snapshot is not None:
            self._publish_remote(*snapshot)  # network IO outside the lock
        if verbose and self._print_hook:
            self._print_hook(line)

    def _remote_snapshot(self):
        """(seq, content) under self._lock; seq orders concurrent publishes."""
        head = (
            [f"... [{self._remote_truncated} earlier lines truncated] ..."]
            if self._remote_truncated
            else []
        )
        self._publish_seq += 1
        return self._publish_seq, "\n".join(head + self._log_history) + "\n"

    def _publish_remote(self, seq: int, content: str) -> None:
        from maggy_tpu_torch.core.env import EnvSing

        with self._publish_lock:
            if seq <= self._published_seq:
                return  # a newer snapshot already landed; never regress
            try:
                EnvSing.get_instance().dump(content, self._log_file)
                self._published_seq = seq
            except Exception:  # noqa: BLE001 - logs are best-effort
                pass

    def close(self) -> None:
        with self._lock:
            if self._log_fd:
                self._log_fd.close()
                self._log_fd = None
            snapshot = (
                self._remote_snapshot()
                if self._remote_log and self._log_history
                else None
            )
            self._log_history = []
            self._remote_closed = True  # later flushes must not republish a
            # near-empty buffer over the complete final log
        if snapshot is not None:
            self._publish_remote(*snapshot)
