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
* :mod:`~maggy_tpu_torch.telemetry.timeseries` — bounded ring-buffer series
  sampled from a recorder on a fixed tick (``Trainer.fit`` keeps one).
* :mod:`~maggy_tpu_torch.telemetry.flops` — the 6N FLOPs/token estimate and
  the ``mfu_est`` gauge against the card's peak.
* :mod:`~maggy_tpu_torch.telemetry.alerts` — the checked-in alert rules, the
  :class:`AlertEvaluator` over a series store and the
  :class:`RecompileSentinel` (the serving scheduler ticks both).
* :mod:`~maggy_tpu_torch.telemetry.profcap` — alert-triggered
  :class:`ProfileCapture`: a bounded ``torch.profiler`` trace on a CUDA card
  plus a JSON capture.

Wiring: executors build a worker recorder (:func:`worker_telemetry`), install
it as the thread-ambient recorder (:func:`get`), and hand it to the RPC
client so per-verb latencies and heartbeat RTTs record too; every heartbeat
attaches a snapshot that the driver folds into STATUS.
"""

from __future__ import annotations

from maggy_tpu_torch.telemetry import alerts, flightrec, profcap, timeseries, tracing  # noqa: F401
from maggy_tpu_torch.telemetry.alerts import AlertEvaluator, RecompileSentinel  # noqa: F401
from maggy_tpu_torch.telemetry.profcap import ProfileCapture  # noqa: F401
from maggy_tpu_torch.telemetry.histogram import LatencyHistogram  # noqa: F401
from maggy_tpu_torch.telemetry.timeseries import Series, SeriesStore  # noqa: F401
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
    "Series",
    "SeriesStore",
    "tracing",
    "flightrec",
    "timeseries",
    "alerts",
    "profcap",
    "AlertEvaluator",
    "RecompileSentinel",
    "ProfileCapture",
]
