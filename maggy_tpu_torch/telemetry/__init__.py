"""Unified telemetry: the port's copy of what :mod:`maggy_tpu.telemetry` gives
the control plane and the serving engine.

* :mod:`~maggy_tpu_torch.telemetry.recorder` — a process-local
  :class:`Telemetry` recorder with ``span(name)`` context managers and typed
  counters/gauges, buffered per worker. ``MAGGY_TPU_TELEMETRY=0`` swaps in the
  no-op :data:`NULL` (the serving engine's default).
* :mod:`~maggy_tpu_torch.telemetry.sink` — a JSONL sink on the env storage
  seam, ``<exp_dir>/telemetry/worker_<pid>.jsonl``.
* :mod:`~maggy_tpu_torch.telemetry.export` — merges every worker's JSONL into
  one Chrome trace and mirrors gauge series into TensorBoard scalars.
* :mod:`~maggy_tpu_torch.telemetry.tracing` — request-scoped trace ids,
  propagated on every RPC frame.
* :mod:`~maggy_tpu_torch.telemetry.histogram` — fixed-log-bucket latency
  histograms.
* :mod:`~maggy_tpu_torch.telemetry.flightrec` — stall watchdog + flight
  recorder.
* :mod:`~maggy_tpu_torch.telemetry.memtrack` — the device-memory ledger over
  tensors.

``alerts`` and ``timeseries`` come with the scheduler (ROADMAP queue 1
item 6a); ``flightrec.dump`` imports ``alerts`` inside a guard.

Wiring: executors build a worker recorder (:func:`worker_telemetry`), install
it as the thread-ambient recorder (:func:`get`), and hand it to the RPC
client so per-verb latencies and heartbeat RTTs record too; every heartbeat
attaches a snapshot that the driver folds into STATUS.
"""

from __future__ import annotations

from maggy_tpu_torch.telemetry import flightrec, tracing  # noqa: F401
from maggy_tpu_torch.telemetry.histogram import LatencyHistogram  # noqa: F401
from maggy_tpu_torch.telemetry.recorder import (  # noqa: F401
    NULL,
    NullTelemetry,
    Telemetry,
    current,
    enabled,
    get,
    set_current,
)
from maggy_tpu_torch.telemetry.sink import JsonlSink, telemetry_dir, worker_telemetry  # noqa: F401

__all__ = [
    "Telemetry",
    "NullTelemetry",
    "NULL",
    "enabled",
    "get",
    "set_current",
    "current",
    "JsonlSink",
    "telemetry_dir",
    "worker_telemetry",
    "LatencyHistogram",
    "tracing",
    "flightrec",
]
