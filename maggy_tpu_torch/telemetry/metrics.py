"""Checked-in metric-name registry.

The port's copy of :mod:`maggy_tpu.telemetry.metrics`: every
``gauge``/``counter``/``histogram``/``event`` name ``maggy_tpu_torch/``
emits must appear here (``tests/test_torch_metrics_registry.py`` walks the
package and fails on any telemetry call whose literal name is missing), and
the set stays the JAX package's, so a series keeps one name across both.
The failure mode this kills: a typo'd name (``serve.ttft_m``) silently
splits a series into two, and every dashboard/percentile downstream
quietly reads half the data.

Stdlib only: a lint may load it by file path without importing the package.

Adding a metric = add the name here (grouped by kind, with a one-line
meaning) + emit it. Names are grouped per kind because a name may legally
be both a gauge (latest value, monitor panel) and a histogram (full
distribution, SSTATS percentiles) — ``serve.ttft_ms`` is.
"""

from __future__ import annotations

# gauges: latest-value signals (monitor panels, heartbeat snapshots)
GAUGES = frozenset(
    {
        # training loop (train/trainer.py)
        "step_time_ms",  # host wall clock per step
        "step_time_ms_mean",  # mean over the run, compile step excluded
        "compile_time_ms",  # first step, synced to cover the XLA compile
        "steps_per_sec",
        "tokens_per_sec",
        "mfu_est",  # 6*params FLOPs estimate vs detected chip peak
        "metrics_lag",  # steps between a broadcast and its metric
        "metrics_drain_ms",  # host time in the lagged broadcast read
        "resumed_step",  # resume="auto" restore point
        # input pipeline (train/prefetch.py)
        "input_wait_ms",
        "prefetch_depth",
        # checkpointing (train/checkpoint.py)
        "checkpoint_save_ms",
        # control plane (core/rpc.py, core/pod.py)
        "heartbeat_rtt_ms",
        "data_plane_init_ms",
        "driver_connect_ms",
        # serving engine + scheduler (serve/)
        "serve.ttft_ms",
        "serve.tokens_per_sec",
        "serve.queue_depth",
        "serve.active_slots",
        "serve.drain_ms",
        "serve.decode_retraces",
        "serve.prefill_retraces",
        # paged KV cache (serve/paging/, docs/serving.md "Paged KV cache")
        "serve.pages_free",  # allocatable pages left in the pool
        "serve.pages_shared",  # pages aliased by >1 request (prefix reuse)
        # KV page heat + fragmentation (serve/paging/allocator.py heat
        # stamps; docs/observability.md "Capacity")
        "serve.pages_hot",  # pages accessed within the hot generation window
        "serve.pages_warm",  # pages idle past hot but inside warm
        "serve.pages_cold",  # pages idle past the warm window (eviction candidates)
        "serve.fragmentation",  # free-pool frag ratio (0=one run, ->1 shattered)
        # prefix residency (serve/prefix.py residency_stats)
        "serve.prefix_resident_bytes",  # KV bytes pinned by resident prompts
        "serve.prefix_resident_count",  # resident prompts in the prefix index
        # host-DRAM KV tier (serve/tier/, docs/serving.md "Host-DRAM page tier")
        "tier.host_pages_free",  # unallocated host pool pages
        "tier.host_pages_total",  # host pool capacity in pages
        "tier.host_bytes",  # bytes held by resident host packs
        "tier.resident_packs",  # spilled KV packs resident in host DRAM
        # device memory ledger (telemetry/memtrack.py; per-account gauges
        # ride the mem.account. dynamic prefix)
        "mem.hbm_used",  # reported device bytes in use (sim on CPU)
        "mem.hbm_free",  # pool limit minus used
        "mem.headroom_pct",  # free/limit — the autoscaler's capacity signal
        "mem.unattributed",  # reported-used minus the account sum
        # serving fleet (serve/fleet/)
        "fleet.healthy_replicas",
        "fleet.breaker_open",  # circuit breakers currently open (gray replicas)
        "fleet.brownout_level",  # degradation ladder position (0=normal..3=shed)
        # capacity loop (serve/fleet/autoscale.py; docs/fleet.md "Autoscaling")
        "fleet.replicas",  # fleet size (non-dead replicas, any role)
        "fleet.draining",  # replicas mid-retirement (no dispatch, still polled)
        "fleet.at_capacity",  # 1 while scale-out pressure is pinned at max_replicas
        "serve.handoff_ms",  # prefill->decode KV handoff latency
        # autotuner (tune/)
        "tune.candidates",
        "tune.pruned_oom",
        "tune.best_step_time",
        # gradient overlap + ZeRO (parallel/overlap.py, train/trainer.py;
        # docs/distributed.md "Gradient overlap & ZeRO")
        "train.bucket_count",  # gradient-reduction buckets in the compiled step
        "train.comm_exposed_ms",  # comm time still on the critical path
        "train.comm_overlapped_ms",  # comm time hidden under backward
        # autopilot online controller (autopilot/controller.py)
        "autopilot.tick_ms",  # per-sample controller cost (≤2% budget)
        # elastic membership (resilience/membership.py, core/driver/distributed.py)
        "resilience.membership_epoch",  # current membership epoch
        "resilience.active_slices",  # slices currently in the data mesh
        "resilience.reshape_ms",  # epoch bump -> reshape barrier complete
        # alerting (telemetry/alerts.py)
        "alerts.firing",  # alerts currently firing at this scope
    }
)

# counters: monotonic totals
COUNTERS = frozenset(
    {
        "trials_done",
        "trials_errored",
        "checkpoint_fallback",
        "serve.prefix_hits",
        "serve.prefix_tokens_saved",
        "serve.preemptions",  # paged-pool preemptions (request requeued, not failed)
        "fleet.shed",
        "fleet.quarantined",
        "fleet.requeued",
        "fleet.routed",
        # overload robustness (docs/fleet.md "QoS classes", docs/resilience.md
        # "Gray failure & circuit breakers")
        "fleet.brownout_clamped",  # best-effort dispatches with max_new clamped
        "fleet.retry_deferred",  # requeues delayed by an exhausted retry budget
        "fleet.breaker_opened",  # breaker transitions into OPEN (incl. re-opens)
        "fleet.breaker_closed",  # half-open probes that verified recovery
        "fleet.scale_events",  # autoscaler decisions applied (up + down)
        # per-QoS-class scheduler accounting (serve/scheduler.py); the class
        # tail is the closed qos set, spelled out so the lint sees every name
        "serve.qos.admitted.premium",
        "serve.qos.admitted.standard",
        "serve.qos.admitted.best_effort",
        "serve.qos.preempted.premium",
        "serve.qos.preempted.standard",
        "serve.qos.preempted.best_effort",
        "serve.qos.quota_deferred.premium",
        "serve.qos.quota_deferred.standard",
        "serve.qos.quota_deferred.best_effort",
        "resilience.auto_resumes",
        "resilience.preempt_saves",
        "resilience.worker_deaths",
        "resilience.workers_quarantined",
        "resilience.trials_requeued",
        "resilience.trials_exhausted",
        "resilience.dist_restarts",
        # elastic membership (docs/resilience.md "Elastic membership")
        "resilience.slice_drops",  # slices that left the data mesh
        "resilience.slice_rejoins",  # dropped slices re-admitted
        "resilience.reshape_checkpoints",  # graceful-reshape convergence saves
        "resilience.ckpt_reshards",  # restores re-placed across mesh layouts
        "resilience.ckpt_zero_reshards",  # optimizer states converted across zero layouts
        "tune.cache_hits",
        "tune.cache_misses",
        "flightrec.dumps",  # stall watchdog dumps written (telemetry/flightrec.py)
        # series-only SLO attainment counters (telemetry/timeseries.py):
        # ingested into the time-series store from scheduler/router SLO
        # accounting, never emitted via tel.count — registered so alert
        # rules and metrics_query resolve them with units
        "serve.slo_ok",  # requests that met the TTFT SLO
        "serve.slo_miss",  # requests that missed the TTFT SLO
        # series-only headroom low-water tick counters (telemetry/memtrack.py):
        # the counter pair alert.hbm_headroom's multi-window burn reads
        "mem.headroom_ok",  # ledger ticks with headroom above the low-water mark
        "mem.headroom_miss",  # ledger ticks under it (capacity budget burning)
        "profcap.captures",  # alert-triggered profile captures written (telemetry/profcap.py)
        # host-DRAM KV tier (serve/tier/) + prefix-affinity routing
        # (serve/fleet/router.py; docs/fleet.md "Fleet-global KV")
        "tier.spills",  # streams spilled to the host tier (any kind)
        "tier.fills",  # host packs swapped back onto the device
        "tier.spilled_pages",  # KV pages copied device -> host
        "tier.filled_pages",  # KV pages copied host -> device
        "tier.prefix_spills",  # released prefixes captured as host packs
        "tier.prefix_fills",  # admissions served from a host prefix pack
        "tier.host_evictions",  # LRU packs dropped to make host room
        "tier.pressure_spills",  # spills forced by a low-headroom tick
        "tier.affinity_hits",  # routed to a replica holding the prefix
        "tier.affinity_misses",  # no holder available; routed affinity-blind
        # autopilot online controller (autopilot/controller.py)
        "autopilot.diagnoses",  # windows classified
        "autopilot.retunes",  # guarded moves committed
        "autopilot.rollbacks",  # guarded moves reverted on regression
    }
)

# histograms: fixed-log-bucket latency distributions (telemetry/histogram.py)
HISTOGRAMS = frozenset(
    {
        "serve.ttft_ms",  # submit -> first token
        "serve.tpot_ms",  # per-token decode time after the first
        "serve.queue_wait_ms",  # submit -> admission
        "serve.e2e_ms",  # submit -> terminal state
        "serve.drain_ms",  # async decode host drain
        "serve.handoff_ms",  # disaggregated prefill->decode handoff
        "tier.swap_in_ms",  # host pack fetch + device scatter on admit
        "tier.spill_ms",  # device gather + host pack write on spill
        "fleet.drain_ms",  # scale-in drain: dispatch stop -> replica retired
    }
)

# lifecycle events: trace-correlated milestones (telemetry/tracing.py)
EVENTS = frozenset(
    {
        # serving request lifecycle (scheduler-side)
        "req.queued",
        "req.admitted",
        "req.prefix_admitted",
        "req.first_token",
        "req.finished",
        "req.preempted",  # pages freed, requeued ahead of fresh arrivals
        "req.preempted_for_priority",  # victim lost its pages to a higher class
        # router-side hops (serve/fleet/router.py)
        "req.accepted",
        "req.dispatched",
        "req.requeued",
        "req.shed",
        "req.completed",
        # disaggregated prefill/decode (serve/fleet/prefill.py, docs/fleet.md)
        "req.prefilled",  # prompt ran on a prefill replica
        "req.handoff",  # KV pack accepted by a decode replica
        # training runs (train/trainer.py)
        "train.run_start",
        "train.run_end",
        # autopilot decisions (autopilot/controller.py, serve/scheduler.py):
        # the auditable telemetry→config loop — diagnosis verdicts, applied
        # moves, guarded commits, automatic rollbacks
        "autopilot.diagnosis",
        "autopilot.applied",
        "autopilot.committed",
        "autopilot.rollback",
        "autopilot.reconfigure_failed",
        # fleet autoscaler decision journal (serve/fleet/autoscale.py;
        # docs/fleet.md "Autoscaling") — the auditable capacity loop:
        # decisions, safe-event milestones, guarded commits, auto-reverts
        "fleet.scale.up",  # scale-out decided; spawn + warm started
        "fleet.scale.down",  # scale-in decided; victim drain started
        "fleet.scale.admitted",  # warmed replica entered probation dispatch
        "fleet.scale.retired",  # drained (or kill-fallback) replica removed
        "fleet.scale.committed",  # post-scale guard window held
        "fleet.scale.rollback",  # guard regressed; event auto-reverted
        "fleet.scale.guard_extended",  # regression explained by ongoing storm
        "fleet.scale.blocked",  # decision suppressed (at max / warm failed)
        # alert rule transitions (telemetry/alerts.py; the rule name rides
        # in the ``alert=`` attr and must exist in alerts.RULES — linted)
        "alert.firing",
        "alert.resolved",
    }
)

# f-string names whose literal head is one of these prefixes are legal
# (the tail is a bounded enum resolved at runtime: request terminal states,
# RPC verbs)
DYNAMIC_PREFIXES = (
    "serve.requests_",  # scheduler terminal-state counters
    "rpc_errors.",  # per-verb client failures (recorder.rpc)
    "rpc_frame_errors.",  # server frame hygiene (core/rpc.py)
    "train.comm_exposed_ms.",  # per-mesh-axis comm exposure (".data" ICI / ".slice" DCN)
    "serve.qos.",  # per-class tails resolved from the closed qos set
    "mem.account.",  # per-account ledger gauges (telemetry/memtrack.py)
)

BY_KIND = {
    "gauge": GAUGES,
    "count": COUNTERS,
    "histogram": HISTOGRAMS,
    "event": EVENTS,
}

ALL = GAUGES | COUNTERS | HISTOGRAMS | EVENTS

# ---------------------------------------------------------------- units
# Every registered name carries a unit so downstream consumers (monitor
# sparklines, tools/metrics_query.py, the docs signal table) can label and
# scale values without guessing. The lint fails on any registered name
# missing from UNITS or carrying an unknown unit.
VALID_UNITS = frozenset({"ms", "count", "bytes", "ratio", "per_s"})

# counters and events are dimensionally counts; histograms are all latency
# distributions in ms. Gauges are mixed, so each is mapped explicitly —
# adding a gauge means adding its unit here too.
GAUGE_UNITS = {
    "step_time_ms": "ms",
    "step_time_ms_mean": "ms",
    "compile_time_ms": "ms",
    "steps_per_sec": "per_s",
    "tokens_per_sec": "per_s",
    "mfu_est": "ratio",
    "metrics_lag": "count",
    "metrics_drain_ms": "ms",
    "resumed_step": "count",
    "input_wait_ms": "ms",
    "prefetch_depth": "count",
    "checkpoint_save_ms": "ms",
    "heartbeat_rtt_ms": "ms",
    "data_plane_init_ms": "ms",
    "driver_connect_ms": "ms",
    "serve.ttft_ms": "ms",
    "serve.tokens_per_sec": "per_s",
    "serve.queue_depth": "count",
    "serve.active_slots": "count",
    "serve.drain_ms": "ms",
    "serve.decode_retraces": "count",
    "serve.prefill_retraces": "count",
    "serve.pages_free": "count",
    "serve.pages_shared": "count",
    "serve.pages_hot": "count",
    "serve.pages_warm": "count",
    "serve.pages_cold": "count",
    "serve.fragmentation": "ratio",
    "serve.prefix_resident_bytes": "bytes",
    "serve.prefix_resident_count": "count",
    "tier.host_pages_free": "count",
    "tier.host_pages_total": "count",
    "tier.host_bytes": "bytes",
    "tier.resident_packs": "count",
    "mem.hbm_used": "bytes",
    "mem.hbm_free": "bytes",
    "mem.headroom_pct": "ratio",
    "mem.unattributed": "bytes",
    "fleet.healthy_replicas": "count",
    "fleet.breaker_open": "count",
    "fleet.brownout_level": "count",
    "fleet.replicas": "count",
    "fleet.draining": "count",
    "fleet.at_capacity": "count",
    "serve.handoff_ms": "ms",
    "tune.candidates": "count",
    "tune.pruned_oom": "count",
    "tune.best_step_time": "ms",
    "train.bucket_count": "count",
    "train.comm_exposed_ms": "ms",
    "train.comm_overlapped_ms": "ms",
    "autopilot.tick_ms": "ms",
    "resilience.membership_epoch": "count",
    "resilience.active_slices": "count",
    "resilience.reshape_ms": "ms",
    "alerts.firing": "count",
}

UNITS = {name: "count" for name in COUNTERS | EVENTS}
UNITS.update({name: "ms" for name in HISTOGRAMS})
UNITS.update(GAUGE_UNITS)
