"""The no-op recorder: a copy of :class:`maggy_tpu.telemetry.recorder.NullTelemetry`."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional


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
