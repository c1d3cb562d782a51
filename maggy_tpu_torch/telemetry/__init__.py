"""Telemetry, as far as the serving engine calls it.

:class:`NullTelemetry` is the JAX package's no-op recorder
(:mod:`maggy_tpu.telemetry.recorder`): ``span``, ``gauge``, ``count``,
``event`` and ``histogram``. The engine takes any recorder with those
methods and defaults to :data:`NULL`. :mod:`~maggy_tpu_torch.telemetry.memtrack`
is the device-memory ledger over tensors. The full recorder, its sinks and
the rest of the JAX package's telemetry come with the scheduler.
"""

from maggy_tpu_torch.telemetry.recorder import NULL, NullTelemetry

__all__ = ["NULL", "NullTelemetry"]
