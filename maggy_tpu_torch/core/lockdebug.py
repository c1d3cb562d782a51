"""Runtime lock-order assertion (docs/static_analysis.md).

The static analyzer (``tools/check_concurrency.py``) proves the *declared*
lock graph acyclic; this module checks the *observed* one. With
``MAGGY_TPU_LOCK_ORDER=1`` the :func:`lock`/:func:`rlock` factories return
:class:`OrderedLock` wrappers that record every held→acquired pair in a
process-global order graph and raise :class:`LockOrderError` the moment an
acquisition would close a cycle — the acquisition that *could* deadlock
fails loudly on the first inverted interleaving instead of hanging once in
a thousand runs. Unset (the default), the factories return plain
``threading`` primitives with zero overhead, so production code pays
nothing for the instrumentation.

Chaos/fleet tests flip the env var to run the whole serve stack under the
assertion (tests/test_concurrency_lint.py).
"""
import os
import threading
from typing import Dict, List, Set, Tuple

__all__ = [
    "LockOrderError",
    "OrderedLock",
    "enabled",
    "lock",
    "rlock",
    "condition",
    "observed_order",
    "reset",
]

ENV_VAR = "MAGGY_TPU_LOCK_ORDER"


class LockOrderError(RuntimeError):
    """An acquisition closed a cycle in the observed lock-order graph."""


# name -> names observed acquired while it was held; one process-global
# graph so an inversion between two subsystems' locks is caught no matter
# which objects embody them
_graph_lock = threading.Lock()
_order: Dict[str, Set[str]] = {}
_tls = threading.local()


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0")


def reset() -> None:
    """Drop the observed graph (test isolation)."""
    with _graph_lock:
        _order.clear()


def observed_order() -> Dict[str, Tuple[str, ...]]:
    """Copy of the observed held→acquired graph."""
    with _graph_lock:
        return {src: tuple(sorted(dsts)) for src, dsts in _order.items()}


def _held() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _reaches(src: str, dst: str) -> bool:
    # caller holds _graph_lock
    seen: Set[str] = set()
    frontier = [src]
    while frontier:
        n = frontier.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        frontier.extend(_order.get(n, ()))
    return False


def _note_acquire(name: str) -> None:
    held = _held()
    for h in held:
        if h == name:
            continue
        with _graph_lock:
            if _reaches(name, h):
                raise LockOrderError(
                    f"lock-order inversion: acquiring {name!r} while holding "
                    f"{h!r}, but the order {name!r} -> ... -> {h!r} was "
                    "already observed — two threads interleaving these "
                    "acquisitions can deadlock"
                )
            _order.setdefault(h, set()).add(name)


class OrderedLock:
    """A named lock that asserts global acquisition order.

    Forwards the ``_release_save``/``_acquire_restore``/``_is_owned`` trio
    so ``threading.Condition`` built over an ordered rlock keeps exact
    RLock wait semantics.
    """

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _note_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held().append(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        stack = _held()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:
            stack.remove(self.name)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # ---- Condition integration (recursive full-release around wait()) ----

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        stack = _held()
        while self.name in stack:  # wait() drops every recursion level
            stack.remove(self.name)
        return state

    def _acquire_restore(self, state) -> None:
        _note_acquire(self.name)
        self._inner._acquire_restore(state)
        _held().append(self.name)

    def locked(self) -> bool:
        probe = getattr(self._inner, "locked", None)
        return bool(probe()) if probe is not None else False

    def __repr__(self) -> str:
        return f"OrderedLock({self.name!r}, {self._inner!r})"


def lock(name: str):
    """A ``threading.Lock`` — order-asserted when MAGGY_TPU_LOCK_ORDER=1."""
    inner = threading.Lock()
    return OrderedLock(name, inner) if enabled() else inner


def rlock(name: str):
    """A ``threading.RLock`` — order-asserted when MAGGY_TPU_LOCK_ORDER=1."""
    inner = threading.RLock()
    return OrderedLock(name, inner) if enabled() else inner


def condition(name: str):
    """A ``threading.Condition`` over an order-asserted rlock."""
    return threading.Condition(rlock(name))
