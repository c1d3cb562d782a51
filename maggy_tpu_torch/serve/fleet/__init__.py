"""Serving fleet: a router front-end over N engine replicas.

The port's counterpart of :mod:`maggy_tpu.serve.fleet`: the scale-out layer
above the single continuous-batching engine (:mod:`maggy_tpu_torch.serve`).
Each replica is a full engine+scheduler+RPC stack on a card lease, and the
:class:`Router` is the one public address — the same SUBMIT/POLL/CANCEL/
SSTATS verbs, so clients and the monitor are fleet-oblivious. The router
load-balances with SLO-aware admission control (shed or queue on projected
TTFT), probes replica health into the resilience quarantine machinery,
requeues a dead replica's in-flight requests to survivors, and respawns
within a restart budget. Replicas on one card share one copy of the
serving weights, so a fleet fits where its engines' KV pools fit.

    spec = ReplicaSpec(cfg, params, num_slots=4)
    router = launch_fleet(spec, replicas=2, prefill_replicas=1, slo_ttft_ms=2000)
    host, port = router.start(host="127.0.0.1")
    # ... ServeClient((host, port), router.secret) as usual
    router.stop()

Without CUDA, ``device="cpu"`` runs the fleet on the CPU; with neither,
:func:`launch_fleet` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from maggy_tpu_torch.serve.fleet.autoscale import (  # noqa: F401
    AutoscaleConfig,
    Autoscaler,
)
from maggy_tpu_torch.serve.fleet.prefill import (  # noqa: F401
    PrefillWorker,
    PrefillWorkerError,
)
from maggy_tpu_torch.serve.fleet.replica import (  # noqa: F401
    Replica,
    ReplicaSpec,
    build_replicas,
)
from maggy_tpu_torch.serve.fleet.router import (  # noqa: F401
    Router,
    RouterConfig,
    projected_ttft_ms,
)

__all__ = [
    "AutoscaleConfig",
    "Autoscaler",
    "PrefillWorker",
    "PrefillWorkerError",
    "Replica",
    "ReplicaSpec",
    "Router",
    "RouterConfig",
    "build_replicas",
    "launch_fleet",
    "projected_ttft_ms",
]


def launch_fleet(
    spec: ReplicaSpec,
    replicas: int = 2,
    config: Optional[RouterConfig] = None,
    secret: Optional[str] = None,
    name: str = "maggy-fleet",
    host: str = "127.0.0.1",
    telemetry_recorder=None,
    autopilot=None,
    autoscale=None,
    prefill_replicas: int = 0,
    device=None,
    **config_kwargs,
) -> Router:
    """Build a router over ``replicas`` fresh in-process replicas (card
    leases carved like trial leases, round-robin). Call ``router.start()``
    to serve; extra kwargs go to :class:`RouterConfig` (``slo_ttft_ms=...``
    etc.); ``autoscale`` (True or an :class:`AutoscaleConfig`) attaches the
    fleet autoscaler, which grows and shrinks the replica pool between its
    min/max bounds with drain-safe scale events. ``autopilot`` raises
    (ROADMAP queue 1 item 9). ``device`` overrides ``spec.device``.

    ``prefill_replicas > 0`` builds a DISAGGREGATED fleet: ``replicas``
    decode-role replicas plus that many prefill-role replicas — the router
    prefills each prompt on a prefill replica and hands the KV pack to a
    decode replica. The serving weights are cast once per leased card and
    shared by every replica on it, prefill replicas included."""
    if config is None:
        config = RouterConfig(**config_kwargs)
    elif config_kwargs:
        raise ValueError("pass either config= or RouterConfig kwargs, not both")
    if device is not None:
        spec = dataclasses.replace(spec, device=device)
    if spec.slo_ttft_ms is None and config.slo_ttft_ms is not None:
        # thread the fleet SLO down so each replica's scheduler counts
        # exact per-request attainment in its own SSTATS
        spec = dataclasses.replace(spec, slo_ttft_ms=config.slo_ttft_ms)
    fleet = build_replicas(
        dataclasses.replace(spec, role="decode") if prefill_replicas else spec,
        replicas,
        secret or "",
        host=host,
    )
    if prefill_replicas:
        prefill_spec = dataclasses.replace(spec, role="prefill")
        for i in range(prefill_replicas):
            fleet.append(
                Replica(replicas + i, prefill_spec, secret or "", host=host)
            )
    return Router(
        fleet,
        config=config,
        secret=secret,
        name=name,
        telemetry_recorder=telemetry_recorder,
        autopilot=autopilot,
        autoscale=autoscale,
    )
