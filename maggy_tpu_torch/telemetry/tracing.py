"""Request-scoped distributed tracing: trace ids and their propagation.

A *trace* follows one unit of work across every worker it touches — a
serving request hopping client → router → replica → engine (→ requeue to a
survivor), or one ``Trainer.fit`` run. The machinery is deliberately tiny:

* :func:`new_trace_id` mints an opaque id (once, at the edge where the work
  enters the system: ``ServeClient.submit``, the router's SUBMIT handler
  for traceless clients, ``Trainer.fit`` per run).
* A thread-local *current trace* (:func:`current` / :func:`scope`) makes the
  id ambient within a worker, so instrumentation deep in the stack — the
  recorder's spans, gauges, and lifecycle events — tags records without any
  plumbing through intermediate signatures.
* The RPC layer propagates it across processes: ``rpc.Client._request``
  attaches the ambient id as a ``trace`` field on every outgoing frame, and
  ``rpc.Server._dispatch`` re-installs an incoming frame's id around the
  handler. One request's records therefore share one trace id across every
  worker JSONL, and the Chrome-trace exporter folds them into a single
  per-request lane (docs/observability.md).

Everything here is allocation-free on the hot path (one thread-local read);
there is no sampling — traces are cheap enough to always be on, and
``MAGGY_TPU_TELEMETRY=0`` already disables the recording they feed.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
from typing import Iterator, Optional

_tls = threading.local()


def new_trace_id() -> str:
    """Mint a fresh trace id (opaque hex, unique per process lifetime)."""
    return secrets.token_hex(8)


def current() -> Optional[str]:
    """This thread's ambient trace id, or None outside any trace scope."""
    return getattr(_tls, "trace", None)


def set_current(trace: Optional[str]) -> None:
    """Install ``trace`` as this thread's ambient id (None to clear).
    Prefer :func:`scope` — it restores the previous id on exit."""
    _tls.trace = trace


@contextlib.contextmanager
def scope(trace: Optional[str]) -> Iterator[Optional[str]]:
    """Make ``trace`` ambient for the block (restores the prior id after).
    ``scope(None)`` deliberately masks any outer trace — an RPC handler
    serving a traceless frame must not leak the previous frame's id."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


def ensure() -> str:
    """The ambient trace id, minting a fresh one if none is in scope.
    Does NOT install the minted id — pair with :func:`scope` for that."""
    return current() or new_trace_id()
