"""Preemption notice handling: one final synchronous save before eviction.

A copy of :mod:`maggy_tpu.resilience.preemption`. Preemptible hosts deliver
SIGTERM with a grace window before reclaiming the machine. ``Trainer.fit``
installs this hook when it holds a checkpointer: the handler only sets an
event (signal-safe), and the training loop checks it at step boundaries — on notice it performs one final *synchronous*
checkpoint save and returns early, so ``fit(resume="auto")`` on the
replacement host loses zero completed steps.

Signal handlers can only be installed from the main thread; executor threads
(HPO trial workers) call :func:`install` too, where it degrades to the
shared event — which tests and launchers can set directly via
:func:`request`. The hook is a process-wide singleton: a host gets one
SIGTERM regardless of how many trainer loops it runs.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionHook:
    def __init__(self) -> None:
        self._event = threading.Event()
        self._installed = False
        self._prev = None

    def install(self) -> "PreemptionHook":
        """Idempotently install the SIGTERM handler (main thread only;
        elsewhere the event alone is armed)."""
        if not self._installed and threading.current_thread() is threading.main_thread():
            try:
                self._prev = signal.getsignal(signal.SIGTERM)
                signal.signal(signal.SIGTERM, self._handler)
                self._installed = True
            except (ValueError, OSError):  # embedded interpreters may refuse
                pass
        return self

    def _handler(self, signum, frame) -> None:
        self._event.set()
        # chain a pre-existing handler (e.g. a launcher's own cleanup)
        if callable(self._prev) and self._prev not in (
            signal.SIG_IGN,
            signal.SIG_DFL,
        ):
            self._prev(signum, frame)

    def request(self) -> None:
        """Raise the preemption flag programmatically (tests, launchers that
        learn about eviction out-of-band, chaos harness)."""
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        self._event.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


HOOK = PreemptionHook()


def install() -> PreemptionHook:
    return HOOK.install()


def request() -> None:
    HOOK.request()


def requested() -> bool:
    return HOOK.requested()


def clear() -> None:
    HOOK.clear()
