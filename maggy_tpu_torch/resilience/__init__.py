"""Fault-tolerant experiment runtime: the port's copy of
:mod:`maggy_tpu.resilience` as far as the control plane uses it.

The reference maggy gets fault tolerance for free from Spark re-running
executor tasks (spark_driver.py:136-145); this runtime replaced Spark with
its own RPC drivers, so recovery is a runtime concern here instead:

* :mod:`maggy_tpu_torch.resilience.policy` — transient-vs-deterministic failure
  classification, :class:`RetryPolicy` (per-trial retry budget + exponential
  backoff with deterministic jitter), and :class:`QuarantineTracker`
  (a worker whose consecutive trials keep dying is taken out of scheduling
  for a cooldown window).
* :mod:`maggy_tpu_torch.resilience.preemption` — the SIGTERM/preemption
  hook ``Trainer.fit`` installs when it holds a checkpointer: one final
  synchronous save before the process dies.
* :mod:`maggy_tpu_torch.resilience.chaos` — deterministic fault injector (kill
  worker N at step K, drop heartbeats, stall an RPC reply, ...) on a
  config/env seam, so recovery paths are testable on CPU without real
  preemptions.
* :mod:`maggy_tpu_torch.resilience.membership` — epoch-numbered elastic
  membership views, for the distributed driver (ROADMAP queue 1 item 7f2).

Consumers: ``core/driver/hpo.py`` (trial requeue + quarantine),
``train/trainer.py`` (``fit(resume="auto")`` + preemption save),
``train/checkpoint.py`` (restore fallback) and ``core/rpc.py`` (jittered
reconnects, chaos seams). Recovery actions count ``resilience.*``
telemetry.
"""

from __future__ import annotations

from maggy_tpu_torch.resilience.membership import (  # noqa: F401
    MembershipChanged,
    MembershipMonitor,
    MembershipView,
    MembershipViolation,
    SliceLost,
    SliceRejoin,
)
from maggy_tpu_torch.resilience.policy import (  # noqa: F401
    DETERMINISTIC,
    TRANSIENT,
    QuarantineTracker,
    RetryPolicy,
    classify_failure,
)

__all__ = [
    "TRANSIENT",
    "DETERMINISTIC",
    "classify_failure",
    "RetryPolicy",
    "QuarantineTracker",
    "MembershipView",
    "MembershipMonitor",
    "MembershipChanged",
    "MembershipViolation",
    "SliceLost",
    "SliceRejoin",
]
