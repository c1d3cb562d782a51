"""SLO-aware request router over N serving replicas.

The port's counterpart of :mod:`maggy_tpu.serve.fleet.router`, host logic
only: the router never touches a card itself (its pump thread reaches an
engine only through a :class:`PrefillWorker`, which makes the engine's card
current). ``Router(autopilot=)`` raises: ROADMAP queue 1 item 9.

The router is the fleet's only public address. It speaks the exact verb set
a single :class:`~maggy_tpu_torch.serve.server.ServeServer` speaks — SUBMIT /
POLL / CANCEL / SSTATS / STATUS / LOG over :mod:`maggy_tpu_torch.core.rpc` — so
every existing client (:class:`~maggy_tpu_torch.serve.ServeClient`, the monitor
dashboard) points at a fleet unchanged. Behind the verbs:

* **Routing.** SUBMIT mints a *router-owned* request id and places the
  request on the least-loaded healthy replica (cached SSTATS: queue depth,
  slot occupancy, TTFT percentiles). The id -> replica binding is sticky:
  POLL and CANCEL always reach the replica that owns the request — and the
  binding, not the replica, is durable: when a replica dies its requests are
  re-bound, the id never changes.
* **SLO-aware admission.** With ``slo_ttft_ms`` set, each SUBMIT is checked
  against the best replica's *projected TTFT* (see ``projected_ttft_ms``).
  Projection over budget either sheds the request with a 429-style ``BUSY``
  reply (``admission="shed"``) or parks it in the router queue until
  capacity frees (``admission="queue"``, the default). No healthy replica
  at all always sheds.
* **Health + requeue.** A pump thread probes replicas (SSTATS heartbeat)
  and feeds failures into :class:`maggy_tpu_torch.resilience.QuarantineTracker` —
  the same policy object that benches flaky HPO workers. A quarantined or
  dead replica's in-flight requests are requeued *ahead of* fresh arrivals
  (the retry-queue-outranks-suggestions rule the HPO driver uses) and
  resubmitted to survivors; until redispatch, POLL reports
  ``state="requeued"``. Dead replicas are respawned within
  ``max_restarts``. The chaos seam
  (``MAGGY_TPU_CHAOS="replica_kill:replica=N"``) kills a busy replica
  deterministically so all of this is testable on one CPU.
* **Autoscaling** (opt-in, docs/fleet.md "Autoscaling"). An
  :class:`~maggy_tpu_torch.serve.fleet.autoscale.Autoscaler` ticked by the pump
  grows/shrinks the fleet from its own time-series: scale-up admits a
  warmed replica behind a half-open probation gate
  (:meth:`admit_replica`); scale-down drains a victim — dispatch stops
  (:meth:`begin_drain`), in-flight waves finish or are spilled and
  requeued to survivors (:meth:`spill_and_requeue`), then the replica and
  every per-replica trace of it are removed (:meth:`retire_replica`).

* **Disaggregated prefill/decode.** Replicas tagged ``role="prefill"``
  (:class:`~maggy_tpu_torch.serve.fleet.replica.ReplicaSpec`) never receive
  SUBMIT dispatches; instead the pump runs each accepted prompt through a
  :class:`~maggy_tpu_torch.serve.fleet.prefill.PrefillWorker` first and hands
  the resulting KV pack to the chosen decode replica
  (``Engine.admit_from_kv`` — the device-put/serialization path).
  ``req.prefilled``/``req.handoff`` events mark the hop on the request's
  trace lane and ``serve.handoff_ms`` measures it; when every prefill
  replica is down the router falls back to plain dispatch (decode replicas
  keep a full engine). See docs/fleet.md "Disaggregated prefill/decode".

Handlers run on the RPC event loop and only touch lock-guarded host state;
every downstream socket round-trip (dispatch, poll fan-out, probes) belongs
to the pump thread.
"""

from __future__ import annotations

import dataclasses
import secrets as secrets_mod
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from maggy_tpu_torch import telemetry
from maggy_tpu_torch.core import lockdebug, rpc
from maggy_tpu_torch.exceptions import RpcError, RpcRejectedError
from maggy_tpu_torch.resilience import chaos as chaos_mod
from maggy_tpu_torch.resilience.policy import QuarantineTracker
from maggy_tpu_torch.serve.fleet.prefill import (
    PrefillWorker,
    PrefillWorkerError,
    pick_worker,
)
from maggy_tpu_torch.serve.fleet.replica import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    DEAD,
    UP,
    CircuitBreaker,
    Replica,
    RetryBudget,
)
from maggy_tpu_torch.serve.prefix import PrefixIndex
from maggy_tpu_torch.serve.qos import BEST_EFFORT, QOS_CLASSES, validate_qos
from maggy_tpu_torch.serve.scheduler import LATENCY_SIGNALS
from maggy_tpu_torch.serve.tier import FleetPrefixMap
from maggy_tpu_torch.telemetry import timeseries, tracing
from maggy_tpu_torch.telemetry.alerts import AlertEvaluator
from maggy_tpu_torch.telemetry.histogram import merge_dicts

# fleet series surfaced as sparkline trends on the monitor panel
TREND_SIGNALS = (
    "serve.queue_depth",
    "serve.tokens_per_sec",
    "serve.ttft_ms",
    "fleet.healthy_replicas",
    "serve.fragmentation",
    "mem.headroom_pct",
)

# router-side request states (downstream states pass through verbatim)
PENDING = "pending"  # accepted, not yet on a replica
ROUTED = "routed"  # live on a replica
REQUEUED = "requeued"  # owner died; waiting for redispatch


@dataclasses.dataclass
class RouterConfig:
    """Admission and health knobs (docs/fleet.md "Admission control")."""

    slo_ttft_ms: Optional[float] = None  # None: admit everything
    admission: str = "queue"  # "queue" | "shed" when projection > SLO
    max_queue: int = 1024  # router-side pending bound
    probe_interval_s: float = 0.25  # SSTATS heartbeat cadence
    # dispatch/poll loop cadence; JAX's is 5 ms. Here every pass is Python
    # that holds the interpreter lock against the host-bound decode loops
    # (at 5 ms the pump took a fifth of a two-replica fleet's wall time,
    # Llama-3-8B on one H100)
    pump_interval_s: float = 0.02
    quarantine_threshold: int = 2  # consecutive probe failures
    quarantine_cooldown_s: float = 30.0
    max_restarts: int = 1  # fleet-wide respawn budget
    default_service_ms: float = 100.0  # TTFT prior before any p50 exists
    # gray-failure circuit breakers (docs/resilience.md): a replica whose
    # windowed TTFT p95 exceeds breaker_ratio x the best healthy peer's
    # (and breaker_min_ms absolute) for breaker_trips consecutive metric
    # ticks is ejected from dispatch; after breaker_cooldown_s, half-open
    # probation probes close it on recovery
    breaker_ratio: float = 3.0
    breaker_min_ms: float = 50.0
    breaker_window_s: float = 10.0
    breaker_trips: int = 2
    breaker_cooldown_s: float = 5.0
    # brownout ladder (docs/fleet.md "QoS classes & graceful degradation"):
    # while the TTFT SLO burn-rate alert fires, degrade best-effort one
    # step per brownout_escalate_s (clamp max_new → queue-only → shed);
    # step back down one level per brownout_recover_s of clean burn
    brownout_clamp_tokens: int = 8
    brownout_escalate_s: float = 3.0
    brownout_recover_s: float = 5.0
    # per-replica requeue budget: a flapping replica may inject at most
    # retry_budget requeues per retry_budget_window_s; beyond that the
    # requeues are deferred (never dropped) so storms can't amplify load
    retry_budget: int = 8
    retry_budget_window_s: float = 10.0
    # prefix-affinity routing (docs/fleet.md "Fleet-global KV"): a replica
    # the fleet prefix map reports holding this prompt's prefix resident
    # gets this many ms subtracted from its projected TTFT — roughly the
    # prefill time the resident prefix saves. 0 disables; the autopilot
    # tunes it (``fleet.affinity_weight``) and brownout level >= 2 zeroes
    # it so affinity never fights load-shedding under overload
    affinity_weight_ms: float = 25.0

    def validate(self) -> None:
        if self.admission not in ("queue", "shed"):
            raise ValueError(
                f"admission must be 'queue' or 'shed', got {self.admission!r}"
            )


def projected_ttft_ms(stats: Dict[str, Any], prior_ms: float) -> float:
    """Projected time-to-first-token on a replica with these SSTATS.

    The model is deliberately simple and stated so operators can reason
    about sheds: a free slot with an empty queue costs one prefill
    (~observed TTFT p50, or the prior before one exists); otherwise the
    request waits behind ``queue_depth`` others served ``num_slots`` at a
    time, each wave costing roughly one observed TTFT."""
    p50 = stats.get("ttft_ms_p50") or prior_ms
    free = stats.get("num_slots", 1) - stats.get("active_slots", 0)
    depth = stats.get("queue_depth", 0)
    if free > 0 and depth == 0:
        return float(p50)
    waves = (depth + 1) / max(1, stats.get("num_slots", 1))
    return float(p50) * (1.0 + waves)


# brownout ladder levels, in escalation order (docs/fleet.md "QoS classes
# & graceful degradation"); the level is the fleet.brownout_level gauge
BROWNOUT_LEVELS = ("normal", "clamp", "queue", "shed")


class BrownoutLadder:
    """Hysteretic stepwise degradation of best-effort traffic.

    While the SLO burn-rate alert fires, escalate one level per
    ``escalate_s``: 1 clamps best-effort ``max_new`` at dispatch, 2 parks
    best-effort in the router queue (dispatch skips it), 3 sheds
    best-effort at admission with a typed BUSY. While the alert is clear,
    recover one level per ``recover_s``. Single-step transitions in both
    directions — never a cliff where premium misses SLO while best-effort
    streams, and never a thundering re-admission when the burn clears.

    Stepped by the pump's metrics tick, read by the RPC admission handler
    and the dispatch loop; the lock makes each timed transition atomic.
    """

    def __init__(self, escalate_s: float = 3.0, recover_s: float = 5.0):
        self.escalate_s = float(escalate_s)
        self.recover_s = float(recover_s)
        self._lock = lockdebug.lock("router.brownout")
        self._level = 0  # guarded-by: _lock
        self._burn_since: Optional[float] = None  # guarded-by: _lock
        self._clear_since: Optional[float] = None  # guarded-by: _lock
        # (ts, level) transition log — deterministic test/ops evidence
        self.history: List[Tuple[float, int]] = []  # guarded-by: _lock

    def level(self) -> int:
        with self._lock:
            return self._level

    def step(self, burning: bool, now: float) -> Tuple[int, Optional[str]]:  # thread-entry — router pump's ~1 Hz metrics tick
        """Advance the ladder one tick; returns (level, transition) where
        transition is ``"escalated"``/``"recovered"`` when the level moved."""
        with self._lock:
            transition = None
            if burning:
                self._clear_since = None
                if self._burn_since is None:
                    self._burn_since = now
                if (
                    self._level < len(BROWNOUT_LEVELS) - 1
                    and now - self._burn_since >= self.escalate_s
                ):
                    self._level += 1
                    self._burn_since = now  # one step per escalate_s
                    self.history.append((now, self._level))
                    transition = "escalated"
            else:
                self._burn_since = None
                if self._clear_since is None:
                    self._clear_since = now
                if (
                    self._level > 0
                    and now - self._clear_since >= self.recover_s
                ):
                    self._level -= 1
                    self._clear_since = now  # one step per recover_s
                    self.history.append((now, self._level))
                    transition = "recovered"
            return self._level, transition

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "level": self._level,
                "name": BROWNOUT_LEVELS[self._level],
                "history": [(round(t, 3), lvl) for t, lvl in self.history],
            }


@dataclasses.dataclass
class RouteEntry:
    """One router-owned request and its sticky downstream binding."""

    rid: str
    payload: Dict[str, Any]  # submit kwargs, replayable on requeue
    # request-scoped trace id: adopted from the client's SUBMIT frame (or
    # minted here for traceless clients) and forwarded on every downstream
    # dispatch — durable across replica death, like the rid
    trace: Optional[str] = None
    state: str = PENDING
    replica: Optional[int] = None
    remote_id: Optional[str] = None
    snapshot: Optional[Dict[str, Any]] = None  # last downstream POLL
    final: Optional[Dict[str, Any]] = None  # router-local terminal snapshot
    submitted_ts: float = dataclasses.field(default_factory=time.time)
    deadline_ts: Optional[float] = None
    resubmits: int = 0
    cancel_requested: bool = False
    cancel_sent: bool = False
    counted_done: bool = False
    # retry-budget damping: a requeue charged against an exhausted budget
    # waits until this instant before redispatch (deferred, never dropped)
    not_before_ts: Optional[float] = None

    @property
    def qos(self) -> str:
        return self.payload.get("qos", BEST_EFFORT)

    def done(self) -> bool:
        if self.final is not None:
            return True
        return bool(self.snapshot and self.snapshot.get("done"))

    def wire(self) -> Dict[str, Any]:
        """POLL reply: downstream snapshot under the ROUTER id."""
        if self.final is not None:
            body = dict(self.final)
        elif self.state == ROUTED and self.snapshot is not None:
            body = dict(self.snapshot)
        else:
            body = {
                "state": "queued" if self.state == PENDING else REQUEUED,
                "tokens": [],
                "n_tokens": 0,
                "prompt_len": len(self.payload.get("prompt", [])),
                "error": None,
                "ttft_ms": None,
                "tenant": self.payload.get("tenant"),
                "qos": self.qos,
                "done": False,
            }
        body["id"] = self.rid
        body["trace"] = self.trace
        body["replica"] = self.replica
        body["resubmits"] = self.resubmits
        return body


class Router:
    """Fleet front-end: one RPC server, N replicas, one pump thread."""

    def __init__(
        self,
        replicas: List[Replica],
        config: Optional[RouterConfig] = None,
        secret: Optional[str] = None,
        name: str = "maggy-fleet",
        telemetry_recorder=None,
        autopilot=None,
        autoscale=None,
    ):
        self.config = config or RouterConfig()
        self.config.validate()
        self.replicas = list(replicas)
        self.name = name
        self.telemetry = telemetry_recorder or telemetry.get()
        # autopilot (docs/autotune.md): an online controller the pump
        # thread would tick
        if autopilot is not None and autopilot is not False:
            raise NotImplementedError(
                "the fleet autopilot is not ported yet (ROADMAP queue 1 item 9)"
            )
        # disaggregation: prefill-role replicas become pump-owned prefill
        # workers and are excluded from SUBMIT dispatch
        self.prefill_workers = [
            PrefillWorker(r)
            for r in self.replicas
            if getattr(r.spec, "role", "any") == "prefill"
        ]
        if self.prefill_workers and not any(
            getattr(r.spec, "role", "any") != "prefill" for r in self.replicas
        ):
            raise ValueError(
                "a disaggregated fleet needs at least one decode-capable "
                "replica (role 'decode' or 'any')"
            )
        self._pw_rr = 0  # prefill-worker round-robin cursor
        self._rpc = rpc.Server(num_executors=0, secret=secret)
        self._rpc.telemetry = self.telemetry
        self.quarantine = QuarantineTracker(
            threshold=self.config.quarantine_threshold,
            cooldown=self.config.quarantine_cooldown_s,
        )
        self._lock = lockdebug.rlock("router._lock")
        self._entries: Dict[str, RouteEntry] = {}
        self._pending: deque = deque()  # rids; requeues go left, fresh right
        self._stats_cache: Dict[int, Dict[str, Any]] = {}
        self._down_handled: set = set()  # replica idx whose death was requeued
        # replicas mid-retirement (autoscaler drain protocol): no new
        # dispatch, still polled so in-flight waves finish  # guarded-by: _lock
        self._draining: set = set()
        # next fleet index for autoscaler-spawned replicas (indices are
        # never reused; they key breakers, stores, the prefix map)
        self._next_index = (
            max((r.index for r in self.replicas), default=-1) + 1
        )  # guarded-by: _lock
        self._restarts_used = 0
        self._rr = 0  # round-robin tie-break cursor
        self.counters: Dict[str, int] = {
            "routed": 0,
            "requeued": 0,
            "shed": 0,
            "completed": 0,
            "failed": 0,
            "expired": 0,
            "cancelled": 0,
            "respawned": 0,
            # disaggregation: prompts run on a prefill replica, and KV
            # packs handed to a decode replica (docs/fleet.md)
            "prefilled": 0,
            "handoffs": 0,
            # requeues damped by an exhausted per-replica retry budget and
            # best-effort dispatches clamped by the brownout ladder
            "retry_deferred": 0,
            "brownout_clamped": 0,
            # prefix-affinity routing: picks that landed on a replica the
            # fleet prefix map reported resident vs. picks where holders
            # existed but load won (docs/fleet.md "Fleet-global KV")
            "affinity_hits": 0,
            "affinity_misses": 0,
        }
        # exact SLO attainment at the fleet edge: counted per completed
        # request against the configured TTFT budget (histogram-derived
        # attainment in SSTATS is the bucket-resolution view of the same)
        self.slo_ok = 0
        self.slo_miss = 0
        # per-QoS-class split of the same fleet-edge judgement, so the
        # no-cliff property (premium holds while best-effort degrades) is
        # observable from SSTATS alone  # guarded-by: _lock
        self.slo_by_class: Dict[str, Dict[str, int]] = {
            c: {"ok": 0, "miss": 0} for c in QOS_CLASSES
        }
        # gray-failure circuit breakers + requeue budgets, one per replica
        # (docs/resilience.md "Gray failure & circuit breakers"); breakers
        # are scored by the pump's metrics tick and filter dispatch
        cfg = self.config
        self.breakers: Dict[int, CircuitBreaker] = {
            r.index: CircuitBreaker(
                r.index, trips=cfg.breaker_trips,
                cooldown_s=cfg.breaker_cooldown_s,
            )
            for r in self.replicas
        }
        self.retry_budgets: Dict[int, RetryBudget] = {
            r.index: RetryBudget(cfg.retry_budget, cfg.retry_budget_window_s)
            for r in self.replicas
        }
        # fleet prefix map (docs/fleet.md "Fleet-global KV"): digest ->
        # replicas holding it resident, fed from the SSTATS residency
        # snapshots the pump already polls; read at dispatch for the
        # affinity bonus
        self.prefix_map = FleetPrefixMap()
        # brownout ladder: stepped by the pump tick off the SLO burn alert
        self.brownout = BrownoutLadder(
            escalate_s=cfg.brownout_escalate_s,
            recover_s=cfg.brownout_recover_s,
        )
        # shed sequence staggers retry_after_ms hints so synchronized
        # clients desynchronize instead of re-storming  # guarded-by: _lock
        self._shed_seq = 0
        self._log: deque = deque(maxlen=500)
        self._closing = False
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None
        self._started_ts = time.time()
        # fleet observability (docs/observability.md "Time series"): one
        # store per replica fed from the SSTATS probe cache, plus a
        # fleet-aggregate store fed at the *same* tick with the bucket-wise
        # merge — the alignment that lets tools/metrics_query.py reproduce
        # fleet windowed percentiles from per-replica snapshots. Alert
        # rules run at fleet scope over the aggregate store.
        self.metrics = timeseries.SeriesStore()
        self.replica_metrics: Dict[int, timeseries.SeriesStore] = {}
        self.alerts = AlertEvaluator(self.metrics, self.telemetry, scope="fleet")
        self._last_metrics_tick = 0.0
        for verb, handler in (
            ("SUBMIT", self._on_submit),
            ("POLL", self._on_poll),
            ("CANCEL", self._on_cancel),
            ("SSTATS", self._on_stats),
            ("STATUS", self._on_status),
            ("LOG", self._on_log),
        ):
            self._rpc.register_callback(verb, handler)
        self._rpc.register_metrics(self._metrics_body)
        # fleet autoscaler (docs/fleet.md "Autoscaling"): ticked by the
        # pump after each metrics tick; drain/admit seams below are its
        # only write surface into the fleet
        self.autoscaler = None
        if autoscale is not None and autoscale is not False:
            from maggy_tpu_torch.serve.fleet.autoscale import (
                AutoscaleConfig,
                Autoscaler,
            )

            self.autoscaler = (
                autoscale
                if isinstance(autoscale, Autoscaler)
                else Autoscaler(
                    self,
                    config=(
                        autoscale
                        if isinstance(autoscale, AutoscaleConfig)
                        else None
                    ),
                )
            )

    @property
    def secret(self) -> str:
        return self._rpc.secret

    # -------------------------------------------------------------- lifecycle

    def start(self, host: str = "0.0.0.0", port: int = 0) -> Tuple[str, int]:
        for replica in self.replicas:
            if replica.state != UP:
                replica.secret = self.secret
                replica.start()
                self.log(
                    f"replica {replica.index} up at "
                    f"{replica.addr[0]}:{replica.addr[1]}"
                )
        addr = self._rpc.start(host=host, port=port)
        self._stop.clear()
        self._pump = threading.Thread(
            target=self._pump_loop, name="maggy-fleet-pump", daemon=True
        )
        self._pump.start()
        self.log(
            f"router on {addr[0]}:{addr[1]} ({len(self.replicas)} replicas, "
            f"slo_ttft_ms={self.config.slo_ttft_ms}, "
            f"admission={self.config.admission})"
        )
        return addr

    def stop(self, drain_timeout: float = 30.0) -> None:
        """Clean shutdown: stop admitting, let replicas finish resident
        work, then close sockets — in that order, so no accepted request is
        dropped by the shutdown itself."""
        with self._lock:
            self._closing = True
        deadline = time.time() + drain_timeout
        while time.time() < deadline:
            with self._lock:
                live = any(
                    not e.done()
                    for e in self._entries.values()
                )
            if not live:
                break
            time.sleep(0.02)
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None
        for replica in self.replicas:
            # replica drain is second-layer insurance (their own queues)
            replica.stop(drain=replica.state == UP, timeout=drain_timeout)
        self._rpc.stop()

    def log(self, line: str) -> None:
        self._log.append(f"[{time.strftime('%H:%M:%S')}] {line}")

    # ------------------------------------------------------------ projections

    def _healthy(self) -> List[Replica]:
        """Dispatch targets: healthy decode-capable replicas (prefill-only
        replicas are PrefillWorkers, never SUBMIT targets; draining
        replicas finish their waves but take nothing new)."""
        now = time.time()
        return [
            r
            for r in self.replicas
            if r.state == UP
            and getattr(r.spec, "role", "any") != "prefill"
            and r.index not in self._draining
            and not self.quarantine.is_quarantined(r.index, now)
        ]

    def _replica(self, index: int) -> Optional[Replica]:
        """Replica by fleet index. Positional indexing into
        ``self.replicas`` is wrong once the autoscaler has retired or
        added replicas — indices are sparse and never reused."""
        for r in self.replicas:
            if r.index == index:
                return r
        return None

    def _pick_replica(  # guarded-by: _lock
        self,
        healthy: List[Replica],
        digest: Optional[str] = None,
        affinity_ms: float = 0.0,
    ) -> Tuple[Replica, float]:
        """Least projected TTFT; round-robin cursor breaks ties so equal
        replicas share load instead of all traffic piling on index 0.

        With a prompt ``digest``, replicas the fleet prefix map reports
        holding that prefix resident get ``affinity_ms`` subtracted from
        their projection (docs/fleet.md "Fleet-global KV") — a bounded
        nudge, so a genuinely overloaded holder still loses the pick; the
        caller zeroes the bonus at brownout level >= 2."""
        cfg = self.config
        holders = (
            self.prefix_map.replicas_for(digest)
            if digest is not None and affinity_ms > 0
            else frozenset()
        )
        # dispatches the replica hasn't reported yet (routed, no poll
        # snapshot) count against its queue now — within one dispatch
        # sweep the stats cache is frozen, so without this correction the
        # whole pending queue dumps on whichever replica reported least
        # loaded at the last probe tick
        unseen: Dict[int, int] = {}
        for e in self._entries.values():
            if e.state == ROUTED and e.snapshot is None and not e.done():
                unseen[e.replica] = unseen.get(e.replica, 0) + 1
        scored = []
        for offset in range(len(healthy)):
            r = healthy[(self._rr + offset) % len(healthy)]
            stats = self._stats_cache.get(r.index, {})
            extra = unseen.get(r.index, 0)
            if extra:
                stats = dict(
                    stats, queue_depth=stats.get("queue_depth", 0) + extra
                )
            proj = projected_ttft_ms(stats, cfg.default_service_ms)
            if r.index in holders:
                proj -= affinity_ms
            scored.append((proj, r))
        proj, best = min(scored, key=lambda pr: pr[0])
        self._rr += 1
        if holders:
            if best.index in holders:
                self.counters["affinity_hits"] += 1
                self.telemetry.count("tier.affinity_hits")
            else:
                self.counters["affinity_misses"] += 1
                self.telemetry.count("tier.affinity_misses")
        return best, proj

    # ------------------------------------------------------- autoscaler seams
    # (pump-thread internals, invoked via Autoscaler.tick — the drain
    # protocol's write surface; like the rest of the pump machinery, the
    # pump thread is the only writer and compound writes hold _lock)

    def allocate_index(self) -> int:
        """Mint a fleet index for a new replica. Indices are never
        reused: every per-replica structure (breakers, SeriesStores, the
        prefix map) keys on them."""
        with self._lock:
            index = self._next_index
            self._next_index += 1
            return index

    def admit_replica(self, replica: Replica, probation: bool = True) -> None:
        """Add a started, warmed replica to the dispatch set. Its breaker
        and quarantine state are built fresh — admission on stale
        pre-spawn samples is the bug class the respawn path also guards
        against. With ``probation`` the breaker starts HALF_OPEN, so the
        dispatch loop's probation-first path routes one canary request at
        a time; only an observed TTFT under the close bar (the TTFT SLO,
        or 10x the service prior without one) closes it and lets the
        replica take weighted traffic (docs/fleet.md "Autoscaling")."""
        cfg = self.config
        breaker = CircuitBreaker(
            replica.index, trips=cfg.breaker_trips,
            cooldown_s=cfg.breaker_cooldown_s,
        )
        if probation:
            close_below = (
                cfg.slo_ttft_ms
                if cfg.slo_ttft_ms is not None
                else 10.0 * cfg.default_service_ms
            )
            breaker.begin_probation(close_below)
        self.quarantine.record_success(replica.index)
        with self._lock:
            # indices are never reused, even when the replica was built
            # outside allocate_index()
            self._next_index = max(self._next_index, replica.index + 1)
            self.replicas = self.replicas + [replica]
            self.breakers[replica.index] = breaker
            self.retry_budgets[replica.index] = RetryBudget(
                cfg.retry_budget, cfg.retry_budget_window_s
            )
            self._stats_cache.pop(replica.index, None)
            self.replica_metrics.pop(replica.index, None)
            self._down_handled.discard(replica.index)
            self._draining.discard(replica.index)
            if getattr(replica.spec, "role", "any") == "prefill":
                self.prefill_workers = self.prefill_workers + [
                    PrefillWorker(replica)
                ]
        self.log(
            f"replica {replica.index} admitted"
            f"{' (probation)' if probation else ''}"
        )

    def begin_drain(self, index: int) -> None:
        """Drain protocol step 1: stop dispatching to the replica without
        touching its liveness. Routed entries keep polling, so in-flight
        waves finish on the victim; the death path skips respawn for a
        draining replica (retirement is deliberate, not a failure)."""
        with self._lock:
            self._draining.add(index)
        self.log(f"replica {index} draining (dispatch stopped)")

    def inflight_on(self, index: int) -> int:
        """Streams still live on a replica (the drain's exit condition)."""
        with self._lock:
            return sum(
                1
                for e in self._entries.values()
                if e.replica == index and e.state == ROUTED and not e.done()
            )

    def spill_and_requeue(self, index: int) -> int:
        """Drain protocol step 2 (when the grace expires): move the
        victim's remaining streams to survivors. Each downstream request
        is cancelled — the victim's scheduler frees its pages, and
        reusable prefix KV spills through the host tier seam on release
        (docs/serving.md "Host-DRAM page tier") — and the router entry is
        requeued ahead of fresh arrivals. Byte-identical by construction:
        engine output is a pure function of (params, prompt, seed), so
        the replay on a survivor regenerates exactly the tokens the
        victim would have produced."""
        replica = self._replica(index)
        moved: List[Tuple[RouteEntry, Optional[str]]] = []
        with self._lock:
            for entry in self._entries.values():
                if (
                    entry.replica == index
                    and entry.state == ROUTED
                    and not entry.done()
                ):
                    remote = entry.remote_id
                    entry.state = REQUEUED
                    entry.replica = None
                    entry.remote_id = None
                    entry.snapshot = None
                    entry.resubmits += 1
                    entry.not_before_ts = None
                    self._pending.appendleft(entry.rid)
                    self.counters["requeued"] += 1
                    moved.append((entry, remote))
        for entry, remote in moved:
            if replica is not None and replica.state == UP and remote:
                try:
                    replica.client.cancel(remote)
                except (RpcError, OSError):
                    pass  # victim half-gone: requeue already happened
            self.telemetry.event(
                "req.requeued", trace=entry.trace, rid=entry.rid,
                replica=index, resubmits=entry.resubmits,
            )
        if moved:
            self.telemetry.count("fleet.requeued", len(moved))
        return len(moved)

    def rebalance_excess(self) -> int:
        """Shed routed-but-unstarted backlog back into the shared queue
        when capacity comes online (a scale-up's probation breaker
        closes, or a gray replica recovers). Work dispatched before the
        fleet widened stays pinned to the replica that absorbed it — the
        victim of the very overload that triggered the scale-out — so a
        fresh replica would otherwise only ever see new arrivals. Each
        replica keeps two waves per slot; anything beyond that which has
        not produced a token yet is cancelled downstream and requeued
        (byte-identical for the same reason the drain spill is: output
        is a pure function of (params, prompt, seed))."""
        moved: List[Tuple[RouteEntry, Replica, Optional[str]]] = []
        with self._lock:
            per: Dict[int, List[RouteEntry]] = {}
            for e in self._entries.values():
                if (
                    e.state == ROUTED
                    and not e.done()
                    and e.replica is not None
                    and (
                        e.snapshot is None
                        or not e.snapshot.get("n_tokens", 0)
                    )
                ):
                    per.setdefault(e.replica, []).append(e)
            for index, entries in per.items():
                replica = self._replica(index)
                if replica is None or index in self._draining:
                    continue
                keep = 2 * int(getattr(replica.spec, "num_slots", 1) or 1)
                if len(entries) <= keep:
                    continue
                # oldest stay (they are next to start); the tail moves,
                # requeued ahead of fresh arrivals in its original order
                entries.sort(key=lambda e: e.submitted_ts)
                for entry in reversed(entries[keep:]):
                    remote = entry.remote_id
                    entry.state = REQUEUED
                    entry.replica = None
                    entry.remote_id = None
                    entry.snapshot = None
                    entry.resubmits += 1
                    entry.not_before_ts = None
                    self._pending.appendleft(entry.rid)
                    self.counters["requeued"] += 1
                    moved.append((entry, replica, remote))
        for entry, replica, remote in moved:
            if replica.state == UP and remote:
                try:
                    replica.client.cancel(remote)
                except (RpcError, OSError):
                    pass  # source replica will drop it at its own pace
            self.telemetry.event(
                "req.requeued", trace=entry.trace, rid=entry.rid,
                replica=replica.index, resubmits=entry.resubmits,
            )
        if moved:
            self.telemetry.count("fleet.requeued", len(moved))
            self.log(f"rebalanced {len(moved)} queued requests fleet-wide")
        return len(moved)

    def retire_replica(self, replica: Replica, timeout: float = 30.0) -> None:
        """Drain protocol step 3: remove the replica from the fleet for
        good — the graceful twin of the death path. Stops it cleanly when
        still UP, then forgets every per-replica trace: FleetPrefixMap
        entries, breaker, retry budget, stats cache, quarantine state, and
        the per-replica SeriesStore. A retired replica must leave no
        ghosts in FSTATS aggregates (regression-tested)."""
        index = replica.index
        if replica.state == UP:
            replica.stop(drain=True, timeout=timeout)
        self.prefix_map.forget_replica(index)
        self.quarantine.record_success(index)
        with self._lock:
            self.replicas = [r for r in self.replicas if r.index != index]
            self.prefill_workers = [
                w for w in self.prefill_workers if w.index != index
            ]
            self.breakers.pop(index, None)
            self.retry_budgets.pop(index, None)
            self._stats_cache.pop(index, None)
            self.replica_metrics.pop(index, None)
            self._down_handled.discard(index)
            self._draining.discard(index)
        self.log(f"replica {index} retired")

    def sweep_now(self) -> None:
        """Run the down-replica sweep immediately (the pump's own sweep
        already ran this iteration when a chaos kill lands mid-drain)."""
        self._sweep_down_replicas()

    # ----------------------------------------------------------------- verbs
    # (event-loop thread: lock-guarded host state only, no sockets)

    def _busy(
        self,
        why: str,
        projected: Optional[float] = None,
        trace: Optional[str] = None,
    ) -> Dict[str, Any]:
        with self._lock:
            self.counters["shed"] += 1
            seq = self._shed_seq
            self._shed_seq += 1
            # retry hint = projected router-queue drain time: pending
            # requests served num_slots at a time across healthy replicas,
            # one service interval per wave; floor keeps an empty-queue
            # shed (no healthy replica, shutdown) from hinting "now"
            slots = sum(r.spec.num_slots for r in self._healthy()) or 1
            drain_ms = max(
                100.0,
                len(self._pending) * self.config.default_service_ms / slots,
            )
        # stagger consecutive sheds across [0, drain_ms) so the retry wave
        # spreads instead of landing as one synchronized storm
        retry_ms = drain_ms + (seq % 8) * drain_ms / 8.0
        self.telemetry.count("fleet.shed")
        self.telemetry.event("req.shed", trace=trace, reason=why)
        reply: Dict[str, Any] = {"type": "BUSY", "error": why}
        if projected is not None:
            reply["projected_ttft_ms"] = round(projected, 1)
        reply["retry_after_ms"] = round(retry_ms, 1)
        # legacy field older clients sleep on; same hint, coarser unit
        reply["retry_after_s"] = round(retry_ms / 1e3, 3)
        return reply

    def _on_submit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        prompt = msg.get("prompt")
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt
        ):
            raise ValueError("prompt must be a list of token ids")
        qos = validate_qos(msg.get("qos"))
        tenant = str(msg.get("tenant") or "") or None
        # brownout level 3: shed best-effort at the door with a typed BUSY
        # (premium/standard admission is untouched at every level)
        if qos == BEST_EFFORT and self.brownout.level() >= 3:
            return self._busy(
                "brownout: best-effort shed", trace=msg.get("trace")
            )
        with self._lock:
            if self._closing:
                return self._busy("router shutting down")
            healthy = self._healthy()
            if not healthy:
                return self._busy("no healthy replica")
            pending_depth = len(self._pending)
            if pending_depth >= self.config.max_queue:
                return self._busy(
                    f"router queue full ({self.config.max_queue})"
                )
            cfg = self.config
            if cfg.slo_ttft_ms is not None:
                # admission control: project TTFT on the best replica, plus
                # one wave per router-queued request ahead of this one
                stats_best = min(
                    (
                        projected_ttft_ms(
                            self._stats_cache.get(r.index, {}),
                            cfg.default_service_ms,
                        )
                        for r in healthy
                    ),
                )
                backlog_ms = (
                    pending_depth
                    * cfg.default_service_ms
                    / max(1, sum(r.spec.num_slots for r in healthy))
                )
                projected = stats_best + backlog_ms
                if projected > cfg.slo_ttft_ms and cfg.admission == "shed":
                    return self._busy(
                        f"projected TTFT {projected:.0f}ms exceeds SLO "
                        f"{cfg.slo_ttft_ms:.0f}ms",
                        projected,
                    )
            rid = secrets_mod.token_hex(8)
            # adopt the client's trace id (or mint one for traceless
            # clients); it is forwarded on every downstream dispatch, so
            # the request keeps ONE trace across router, replica, and any
            # requeue-to-survivor hop
            trace = msg.get("trace") or tracing.new_trace_id()
            payload = {
                "prompt": [int(t) for t in prompt],
                "temperature": float(msg.get("temperature", 0.0)),
                "top_k": int(msg.get("top_k", 0)),
                "max_new": int(msg.get("max_new", 16)),
                "eos_id": int(msg.get("eos_id", -1)),
                "seed": int(msg.get("seed", 0)),
                "trace": trace,
                "qos": qos,
            }
            if tenant:
                payload["tenant"] = tenant
            entry = RouteEntry(rid=rid, payload=payload, trace=trace)
            deadline_s = msg.get("deadline_s")
            if deadline_s:
                entry.deadline_ts = time.time() + float(deadline_s)
                entry.payload["deadline_s"] = float(deadline_s)
            self._entries[rid] = entry
            self._pending.append(rid)
        self.telemetry.event(
            "req.accepted", trace=trace, rid=rid, plen=len(prompt),
            tenant=tenant, qos=qos,
        )
        return {"type": "SUBMIT", "id": rid}

    def _on_poll(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            entry = self._entries.get(str(msg.get("id")))
            if entry is None:
                raise ValueError(f"unknown request {msg.get('id')!r}")
            return {"type": "POLL", **entry.wire()}

    def _on_cancel(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            entry = self._entries.get(str(msg.get("id")))
            if entry is None or entry.done():
                return {"type": "CANCEL", "cancelled": False}
            entry.cancel_requested = True
            if entry.state in (PENDING, REQUEUED):
                self._finish_local(entry, "cancelled")
        return {"type": "CANCEL", "cancelled": True}

    def _finish_local(  # guarded-by: _lock
        self, entry: RouteEntry, state: str, error=None
    ) -> None:
        """Terminal without a downstream snapshot (lock held)."""
        entry.final = {
            "state": state,
            "tokens": [],
            "n_tokens": 0,
            "prompt_len": len(entry.payload.get("prompt", [])),
            "error": error,
            "ttft_ms": None,
            "done": True,
        }
        try:
            self._pending.remove(entry.rid)
        except ValueError:
            pass
        key = {"cancelled": "cancelled", "expired": "expired", "failed": "failed"}[
            state
        ]
        self.counters[key] += 1
        entry.counted_done = True

    def _fleet_stats(self) -> Dict[str, Any]:  # guarded-by: _lock
        """Aggregate + per-replica table (lock held).

        Latency is merged honestly: every replica's SSTATS carries its raw
        fixed-log-bucket histograms under ``latency``; those are added
        bucket-wise per signal (TTFT/TPOT/queue-wait/e2e), so the fleet's
        ``ttft_ms_p50/p90/p95/p99`` are true percentiles over ALL requests
        — not the slowest replica's, not a mean of means. The merged
        encodings ride out under ``latency`` for further aggregation
        (docs/observability.md)."""
        now = time.time()
        table = []
        agg = {
            "queue_depth": len(self._pending),
            "active_slots": 0,
            "num_slots": 0,
            "tokens_out": 0,
            "requests_done": 0,
            "requests_failed": 0,
            "prefix_hits": 0,
            "prefix_tokens_saved": 0,
            "prefill_calls": 0,
            # paged KV cache, summed over paged replicas (docs/serving.md)
            "pages_total": 0,
            "pages_free": 0,
            "pages_shared": 0,
            "preemptions": 0,
        }
        latency_dicts: Dict[str, List[Dict[str, Any]]] = {
            name: [] for name in LATENCY_SIGNALS
        }
        # fleet capacity view (docs/observability.md "Capacity"): page heat
        # and residency sum across replicas; headroom reports the MINIMUM
        # (the tightest replica bounds what the fleet can still admit);
        # top prefixes merge by cross-process digest
        capacity: Dict[str, Any] = {
            "pages_hot": 0,
            "pages_warm": 0,
            "pages_cold": 0,
            "fragmentation": None,
            "headroom_pct": None,
            "resident_bytes": 0,
            "resident_prefixes": 0,
            "top_prefixes": [],
        }
        for r in self.replicas:
            # in-process replicas answer fresh (lock-only, no sockets);
            # remote/dead ones fall back to the probe cache
            local = getattr(r, "local_stats", lambda: None)()
            stats = local or self._stats_cache.get(r.index, {})
            quarantined = self.quarantine.is_quarantined(r.index, now)
            breaker = self.breakers.get(r.index)
            row = {
                **r.describe(),
                "quarantined": quarantined,
                "breaker": breaker.state if breaker is not None else None,
                "queue_depth": stats.get("queue_depth", 0),
                "active_slots": stats.get("active_slots", 0),
                "num_slots": stats.get("num_slots", r.spec.num_slots),
                "requests_done": stats.get("requests_done", 0),
                "tokens_per_sec": stats.get("tokens_per_sec", 0.0),
                "prefix_hits": stats.get("prefix_hits", 0),
                "prefix_tokens_saved": stats.get("prefix_tokens_saved", 0),
                "ttft_ms_p50": stats.get("ttft_ms_p50"),
                "ttft_ms_p95": stats.get("ttft_ms_p95"),
            }
            if quarantined:
                row["state"] = "quarantined"
            if r.state == UP and r.index in self._draining:
                row["state"] = "draining"
            table.append(row)
            if r.state == UP and not quarantined:
                agg["queue_depth"] += stats.get("queue_depth", 0)
            for k in (
                "active_slots",
                "num_slots",
                "tokens_out",
                "requests_done",
                "requests_failed",
                "prefix_hits",
                "prefix_tokens_saved",
                "prefill_calls",
                "preemptions",
            ):
                agg[k] += stats.get(k, 0)
            paging = stats.get("paging") or {}
            if paging.get("paged"):
                for k in ("pages_total", "pages_free", "pages_shared"):
                    agg[k] += paging.get(k, 0)
                row["pages_free"] = paging.get("pages_free")
                heat = paging.get("heat") or {}
                capacity["pages_hot"] += int(heat.get("hot") or 0)
                capacity["pages_warm"] += int(heat.get("warm") or 0)
                capacity["pages_cold"] += int(heat.get("cold") or 0)
                fr = (paging.get("fragmentation") or {}).get("frag_ratio")
                if fr is not None:
                    capacity["fragmentation"] = max(
                        capacity["fragmentation"] or 0.0, float(fr)
                    )
            memory = stats.get("memory") or {}
            hp = memory.get("headroom_pct")
            row["headroom_pct"] = hp
            if hp is not None:
                capacity["headroom_pct"] = (
                    float(hp)
                    if capacity["headroom_pct"] is None
                    else min(capacity["headroom_pct"], float(hp))
                )
            resid = stats.get("prefix_residency") or {}
            capacity["resident_bytes"] += int(resid.get("resident_bytes") or 0)
            capacity["resident_prefixes"] += int(
                resid.get("resident_prefixes") or 0
            )
            for t in resid.get("top") or []:
                capacity["top_prefixes"].append(dict(t, replica=r.index))
            tier = stats.get("tier") or {}
            if tier.get("enabled"):
                agg_tier = capacity.setdefault(
                    "tier",
                    {
                        "replicas": 0,
                        "host_pages_total": 0,
                        "host_pages_free": 0,
                        "resident_packs": 0,
                        "spills": 0,
                        "fills": 0,
                    },
                )
                agg_tier["replicas"] += 1
                for k in (
                    "host_pages_total",
                    "host_pages_free",
                    "resident_packs",
                    "spills",
                    "fills",
                ):
                    agg_tier[k] += int(tier.get(k) or 0)
            for name, d in (stats.get("latency") or {}).items():
                latency_dicts.setdefault(name, []).append(d)
        merged = {
            name: merge_dicts(ds) for name, ds in latency_dicts.items()
        }
        ttft = merged.get("ttft_ms")
        for q, key in ((0.50, "p50"), (0.90, "p90"), (0.95, "p95"), (0.99, "p99")):
            agg[f"ttft_ms_{key}"] = ttft.percentile(q) if ttft else None
        tpot = merged.get("tpot_ms")
        agg["tpot_ms_p50"] = tpot.percentile(0.50) if tpot else None
        agg["tpot_ms_p95"] = tpot.percentile(0.95) if tpot else None
        qw = merged.get("queue_wait_ms")
        agg["queue_wait_ms_p50"] = qw.percentile(0.50) if qw else None
        e2e = merged.get("e2e_ms")
        agg["e2e_ms_p50"] = e2e.percentile(0.50) if e2e else None
        agg["e2e_ms_p95"] = e2e.percentile(0.95) if e2e else None
        agg["latency"] = {
            name: h.to_dict() for name, h in merged.items() if h is not None
        }
        if self.config.slo_ttft_ms is not None:
            agg["slo_ttft_ms"] = self.config.slo_ttft_ms
            agg["slo_ok"] = self.slo_ok
            agg["slo_miss"] = self.slo_miss
            judged = self.slo_ok + self.slo_miss
            # exact edge counters when available; the merged histogram's
            # bucket-interpolated view stands in before any completion
            agg["slo_attainment"] = (
                self.slo_ok / judged
                if judged
                else (ttft.attainment(self.config.slo_ttft_ms) if ttft else None)
            )
        # overload-robustness surfaces (docs/fleet.md "QoS classes &
        # graceful degradation", docs/resilience.md "Gray failure"):
        # ladder level, per-replica breaker states, per-class SLO split
        agg["brownout"] = self.brownout.snapshot()
        agg["breaker_open"] = sum(
            1 for b in self.breakers.values() if b.state != BREAKER_CLOSED
        )
        agg["breakers"] = {
            str(i): b.snapshot() for i, b in self.breakers.items()
        }
        if self.config.slo_ttft_ms is not None:
            agg["slo_by_class"] = {
                c: dict(v) for c, v in self.slo_by_class.items()
            }
        if self.autoscaler is not None:
            agg["autoscale"] = self.autoscaler.snapshot()
        # one residency row per distinct prefix digest: the same system
        # prompt resident on three replicas is ONE fleet anchor pinning
        # 3x the bytes, not three anchors
        by_digest: Dict[str, Dict[str, Any]] = {}
        for t in capacity["top_prefixes"]:
            d = by_digest.setdefault(
                str(t.get("digest")),
                {"digest": t.get("digest"), "bytes": 0, "hits": 0, "replicas": []},
            )
            d["bytes"] += int(t.get("bytes") or 0)
            d["hits"] += int(t.get("hits") or 0)
            d["replicas"].append(t.get("replica"))
        capacity["top_prefixes"] = sorted(
            by_digest.values(),
            key=lambda d: (-d["hits"], -d["bytes"], str(d["digest"])),
        )[:4]
        capacity["prefix_map"] = self.prefix_map.snapshot()
        agg["capacity"] = capacity
        # ALERTS surface: fleet-scope rules plus whatever each replica's
        # worker-scope evaluator reports in its SSTATS
        alerts = list(self.alerts.firing())
        for r in self.replicas:
            stats = self._stats_cache.get(r.index) or {}
            for a in stats.get("alerts") or []:
                alerts.append(dict(a, replica=r.index))
        agg["alerts"] = alerts
        agg["trends"] = self.metrics.trends(TREND_SIGNALS)
        return {
            **agg,
            "replicas": table,
            "routing": dict(self.counters),
            "in_flight": sum(
                1 for e in self._entries.values() if not e.done()
            ),
            "uptime_s": round(time.time() - self._started_ts, 3),
        }

    def _on_stats(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            return {"type": "SSTATS", "fleet": True, **self._fleet_stats()}

    def _metrics_body(self) -> Dict[str, Any]:
        """METRICS verb: aligned per-replica + fleet-aggregate series."""
        with self._lock:
            replicas = {
                str(idx): store.snapshot()
                for idx, store in self.replica_metrics.items()
            }
        return {
            "scope": "fleet",
            "metrics": self.metrics.snapshot(),
            "replicas": replicas,
            "alerts": self.alerts.firing(),
        }

    def _sample_metrics(self, now: float) -> None:
        """One aligned fleet observability tick (pump thread, ~1 Hz).

        Appends each replica's cached cumulative stats to its per-replica
        store AND the bucket-wise merge of the same snapshots to the fleet
        store at the same timestamp, then evaluates the fleet-scope alert
        rules. Using one ``now`` for every append is what makes windowed
        fleet queries equal the merge of windowed per-replica queries."""
        if now - self._last_metrics_tick < self.metrics.interval_s:
            return
        self._last_metrics_tick = now
        with self._lock:
            cache = {
                r.index: self._stats_cache.get(r.index)
                for r in self.replicas
            }
            pending = len(self._pending)
            draining = len(self._draining)
            n_replicas = sum(1 for r in self.replicas if r.state != DEAD)
        latency_all: Dict[str, List[Dict[str, Any]]] = {}
        slo_ok_sum = 0
        slo_miss_sum = 0
        have_replica_slo = False
        fleet_gauges = {
            "serve.queue_depth": float(pending),
            "fleet.healthy_replicas": float(len(self._healthy())),
            # capacity-loop surfaces (docs/fleet.md "Autoscaling"): fleet
            # size, replicas mid-drain, and scale-out pressure pinned at
            # max_replicas (the alert.fleet_at_capacity input)
            "fleet.replicas": float(n_replicas),
            "fleet.draining": float(draining),
            "fleet.at_capacity": (
                1.0
                if self.autoscaler is not None and self.autoscaler.at_capacity()
                else 0.0
            ),
        }
        tokens_per_sec = 0.0
        # fleet capacity accumulators: heat/residency sum across replicas;
        # headroom takes the MINIMUM — the tightest replica is the one the
        # next admission can actually land on
        heat_sum = {"hot": 0.0, "warm": 0.0, "cold": 0.0}
        have_heat = False
        frag_max = None
        resid_bytes = resid_count = 0.0
        have_resid = False
        headroom_min = None
        for idx, stats in cache.items():
            if not stats:
                continue
            with self._lock:
                store = self.replica_metrics.get(idx)
                if store is None:
                    store = timeseries.SeriesStore(self.metrics.interval_s)
                    self.replica_metrics[idx] = store
            hists = {
                f"serve.{name}": d
                for name, d in (stats.get("latency") or {}).items()
            }
            counters = {"serve.requests_done": stats.get("requests_done", 0)}
            if stats.get("slo_ok") is not None:
                have_replica_slo = True
                slo_ok_sum += int(stats.get("slo_ok") or 0)
                slo_miss_sum += int(stats.get("slo_miss") or 0)
                counters["serve.slo_ok"] = stats.get("slo_ok")
                counters["serve.slo_miss"] = stats.get("slo_miss")
            paging = stats.get("paging") or {}
            heat = paging.get("heat") or {}
            frag = paging.get("fragmentation") or {}
            resid = stats.get("prefix_residency") or {}
            memory = stats.get("memory") or {}
            # feed the fleet prefix map from this replica's residency
            # sample — device-resident anchors plus host-tier prefix packs
            # (a spilled prefix is still one cheap swap-in away); called
            # outside _lock (prefix_map has its own leaf lock) so a slow
            # snapshot never stalls dispatch
            self.prefix_map.update(
                idx,
                [
                    str(t.get("digest"))
                    for t in (resid.get("top") or [])
                    if t.get("digest")
                ]
                + [
                    str(d)
                    for d in (stats.get("tier") or {}).get("prefix_digests")
                    or []
                ],
            )
            store.ingest(
                now,
                gauges={
                    "serve.queue_depth": stats.get("queue_depth"),
                    "serve.active_slots": stats.get("active_slots"),
                    "serve.tokens_per_sec": stats.get("tokens_per_sec"),
                    "serve.ttft_ms": stats.get("ttft_ms_p95"),
                    "serve.pages_free": paging.get("pages_free"),
                    "serve.pages_hot": heat.get("hot"),
                    "serve.pages_warm": heat.get("warm"),
                    "serve.pages_cold": heat.get("cold"),
                    "serve.fragmentation": frag.get("frag_ratio"),
                    "serve.prefix_resident_bytes": resid.get("resident_bytes"),
                    "serve.prefix_resident_count": resid.get("resident_prefixes"),
                    "mem.headroom_pct": memory.get("headroom_pct"),
                },
                counters=counters,
                hists=hists,
            )
            if heat:
                have_heat = True
                for k in heat_sum:
                    heat_sum[k] += float(heat.get(k) or 0.0)
            if frag.get("frag_ratio") is not None:
                f = float(frag["frag_ratio"])
                frag_max = f if frag_max is None else max(frag_max, f)
            if resid:
                have_resid = True
                resid_bytes += float(resid.get("resident_bytes") or 0.0)
                resid_count += float(resid.get("resident_prefixes") or 0.0)
            hp = memory.get("headroom_pct")
            if hp is not None:
                headroom_min = (
                    float(hp) if headroom_min is None else min(headroom_min, float(hp))
                )
            tokens_per_sec += float(stats.get("tokens_per_sec") or 0.0)
            for name, d in (stats.get("latency") or {}).items():
                latency_all.setdefault(name, []).append(d)
        fleet_gauges["serve.tokens_per_sec"] = round(tokens_per_sec, 2)
        if have_heat:
            fleet_gauges["serve.pages_hot"] = heat_sum["hot"]
            fleet_gauges["serve.pages_warm"] = heat_sum["warm"]
            fleet_gauges["serve.pages_cold"] = heat_sum["cold"]
        if frag_max is not None:
            fleet_gauges["serve.fragmentation"] = frag_max
        if have_resid:
            fleet_gauges["serve.prefix_resident_bytes"] = resid_bytes
            fleet_gauges["serve.prefix_resident_count"] = resid_count
        if headroom_min is not None:
            fleet_gauges["mem.headroom_pct"] = headroom_min
        merged_hists: Dict[str, Dict[str, Any]] = {}
        for name, ds in latency_all.items():
            h = merge_dicts(ds)
            if h is not None:
                merged_hists[f"serve.{name}"] = h.to_dict()
        if merged_hists.get("serve.ttft_ms"):
            p95 = timeseries.hist_delta(merged_hists["serve.ttft_ms"], None)
            fleet_gauges["serve.ttft_ms"] = p95.percentile(0.95) if p95 else None
        # exact fleet-edge SLO counters when the router judges TTFT itself;
        # the sum of replica-side counters stands in otherwise
        counters = {}
        if self.config.slo_ttft_ms is not None:
            with self._lock:
                counters = {
                    "serve.slo_ok": self.slo_ok,
                    "serve.slo_miss": self.slo_miss,
                }
        elif have_replica_slo:
            counters = {"serve.slo_ok": slo_ok_sum, "serve.slo_miss": slo_miss_sum}
        # brownout ladder: stepped off the LAST tick's burn-rate verdict
        # (one-tick lag is in the noise next to the hysteresis windows);
        # the level gauge lands in the same ingest the alert.brownout
        # threshold rule reads, so entry/exit alerts fire for free
        burning = any(
            a.get("alert") == "alert.ttft_slo_burn" for a in self.alerts.firing()
        )
        level, transition = self.brownout.step(burning, now)
        if transition is not None:
            self.log(
                f"brownout {transition} -> level {level} "
                f"({BROWNOUT_LEVELS[level]})"
            )
        fleet_gauges["fleet.brownout_level"] = float(level)
        self.telemetry.gauge("fleet.brownout_level", float(level))
        # gray-failure breaker scoring over the per-replica windowed TTFT
        # p95s ingested above (docs/resilience.md)
        self._score_breakers(now)
        open_count = sum(
            1 for b in self.breakers.values() if b.state != BREAKER_CLOSED
        )
        fleet_gauges["fleet.breaker_open"] = float(open_count)
        self.telemetry.gauge("fleet.breaker_open", float(open_count))
        self.telemetry.gauge("fleet.replicas", fleet_gauges["fleet.replicas"])
        self.telemetry.gauge(
            "fleet.at_capacity", fleet_gauges["fleet.at_capacity"]
        )
        self.metrics.ingest(now, gauges=fleet_gauges, counters=counters, hists=merged_hists)
        self.alerts.evaluate(now)
        self.telemetry.gauge("alerts.firing", float(len(self.alerts.firing())))

    def _score_breakers(self, now: float) -> None:
        """Feed each dispatchable replica's windowed TTFT p95 to its
        breaker, scored against the BEST (minimum) peer p95 — with two
        replicas a median would be dragged up by the gray one, so the
        healthy peer is the honest baseline (pump thread)."""
        cfg = self.config
        p95s: Dict[int, Optional[float]] = {}
        for r in self.replicas:
            if r.state != UP or getattr(r.spec, "role", "any") == "prefill":
                continue
            with self._lock:
                store = self.replica_metrics.get(r.index)
            series = store.get("serve.ttft_ms") if store is not None else None
            p95s[r.index] = (
                series.percentile(0.95, cfg.breaker_window_s, now)
                if series is not None
                else None
            )
        for idx, p95 in p95s.items():
            breaker = self.breakers.get(idx)
            if breaker is None:
                continue
            peers = [
                v
                for i, v in p95s.items()
                if i != idx
                and v is not None
                and self.breakers[i].state == BREAKER_CLOSED
            ]
            peer = min(peers) if peers else None
            transition = breaker.score(
                p95, peer, cfg.breaker_ratio, cfg.breaker_min_ms, now
            )
            if transition == "opened":
                self.telemetry.count("fleet.breaker_opened")
                self.log(
                    f"breaker OPEN on replica {idx}: ttft p95 "
                    f"{p95:.0f}ms vs peer {peer:.0f}ms"
                )

    def _on_status(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            stats = self._fleet_stats()
        status: Dict[str, Any] = {
            "type": "STATUS",
            "name": self.name,
            "kind": "serve-fleet",
            "state": "closing" if self._closing else "serving",
            "app_id": self.name,
            "run_id": 0,
            "elapsed_s": time.time() - self._started_ts,
            "serve": stats,
            "fleet": {
                "replicas": stats["replicas"],
                "routing": stats["routing"],
            },
        }
        tel = self.telemetry
        if getattr(tel, "active", False):
            snap = tel.snapshot()
            if snap:
                status["telemetry"] = {"router": snap}
        return status

    def _on_log(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            lines = list(self._log)
            self._log.clear()
            stats = self._fleet_stats()
        progress = (
            f"replicas {sum(1 for r in stats['replicas'] if r['state'] == UP)}"
            f"/{len(self.replicas)}  queue {stats['queue_depth']}  "
            f"done {stats['requests_done']}  "
            f"requeued {stats['routing']['requeued']}"
        )
        return {"type": "LOG", "logs": lines, "progress": progress}

    # ------------------------------------------------------------------ pump
    # (single background thread: all downstream sockets live here)

    # terminal entries stay pollable this long (mirrors scheduler retention)
    RETENTION_S = 300.0

    def _retire_old(self, now: float) -> None:
        with self._lock:
            dead = [
                rid
                for rid, e in self._entries.items()
                if e.done() and now - e.submitted_ts > self.RETENTION_S
            ]
            for rid in dead:
                del self._entries[rid]

    def _pump_loop(self) -> None:
        last_probe = 0.0
        while not self._stop.is_set():
            now = time.time()
            try:
                if now - last_probe >= self.config.probe_interval_s:
                    self._probe_replicas()
                    self._sample_metrics(now)
                    self._retire_old(now)
                    last_probe = now
                self._chaos_tick()
                self._sweep_down_replicas()
                self._dispatch_pending(time.time())
                self._poll_routed()
                if self.autoscaler is not None and not self._closing:
                    self.autoscaler.tick(time.time())
            except Exception as e:  # noqa: BLE001 - pump must survive anything
                self.log(f"pump error: {type(e).__name__}: {e}")
            self._stop.wait(self.config.pump_interval_s)

    def _probe_replicas(self) -> None:
        for replica in self.replicas:
            if replica.state != UP:
                self._note_failure(replica, "down")
                continue
            try:
                stats = replica.client.stats()
            except (RpcError, OSError) as e:
                self._note_failure(replica, f"{type(e).__name__}: {e}")
                continue
            with self._lock:
                self._stats_cache[replica.index] = stats
            self.quarantine.record_success(replica.index)
            with self._lock:
                self._down_handled.discard(replica.index)
        self.telemetry.gauge(
            "fleet.healthy_replicas", float(len(self._healthy()))
        )

    def _note_failure(self, replica: Replica, why: str) -> None:
        tripped = self.quarantine.record_failure(replica.index)
        if tripped:
            self.log(f"replica {replica.index} quarantined ({why})")
            self.telemetry.count("fleet.quarantined")
        # a closed port IS death — don't wait out the probe threshold
        if replica.state == DEAD or self.quarantine.is_quarantined(replica.index):
            self._handle_replica_down(replica)

    def _handle_replica_down(self, replica: Replica) -> None:
        """Requeue the dead/quarantined replica's in-flight requests ahead
        of fresh arrivals, then respawn it if budget remains. Requeues
        beyond the replica's retry budget are deferred (not_before_ts), so
        a flapping replica can't turn its backlog into a requeue storm."""
        now = time.time()
        # a half-open probation probe bound here is lost, not answered
        breaker = self.breakers.get(replica.index)
        if breaker is not None:
            breaker.probe_lost()
        # a dead replica's resident prefixes are unreachable — drop its
        # contribution so affinity never routes toward a corpse
        self.prefix_map.forget_replica(replica.index)
        with self._lock:
            if replica.index in self._down_handled:
                return
            self._down_handled.add(replica.index)
            moved = 0
            deferred = 0
            requeued_entries = []
            budget = self.retry_budgets.get(replica.index)
            for entry in self._entries.values():
                if entry.replica == replica.index and not entry.done():
                    entry.state = REQUEUED
                    entry.replica = None
                    entry.remote_id = None
                    entry.snapshot = None
                    entry.resubmits += 1
                    if budget is not None and not budget.consume(now):
                        # budget dry: still requeued, but the dispatch loop
                        # waits this entry out (backoff grows per resubmit)
                        entry.not_before_ts = now + 0.25 * entry.resubmits
                        deferred += 1
                    self._pending.appendleft(entry.rid)
                    requeued_entries.append(entry)
                    moved += 1
            self.counters["requeued"] += moved
            self.counters["retry_deferred"] += deferred
        if deferred:
            self.telemetry.count("fleet.retry_deferred", deferred)
        for entry in requeued_entries:
            # explicit hop milestone: the SAME trace id continues on the
            # survivor, so the exported lane shows the loss + re-run inline
            self.telemetry.event(
                "req.requeued", trace=entry.trace, rid=entry.rid,
                replica=replica.index, resubmits=entry.resubmits,
            )
        with self._lock:
            self._stats_cache.pop(replica.index, None)
            # a draining replica's death is the kill-mid-drain fallback:
            # its requeue above is the recovery, retirement finishes in
            # the autoscaler — never respawn what we were removing
            respawn = (
                replica.state == DEAD
                and replica.index not in self._draining
                and self._restarts_used < self.config.max_restarts
            )
            if respawn:
                self._restarts_used += 1
        if moved:
            self.log(
                f"replica {replica.index} down: requeued {moved} request(s) "
                "to survivors"
            )
            self.telemetry.count("fleet.requeued", moved)
        if respawn:
            try:
                addr = replica.respawn()
            except Exception as e:  # noqa: BLE001 - respawn is best-effort within budget
                self.log(
                    f"replica {replica.index} respawn failed: "
                    f"{type(e).__name__}: {e}"
                )
                return
            self.quarantine.record_success(replica.index)
            # the respawned stack shares nothing with the dead one: a
            # breaker window or SeriesStore built from pre-death latency
            # samples would re-open/re-trip the fresh replica on its
            # predecessor's ghosts (regression-tested)
            breaker = self.breakers.get(replica.index)
            if breaker is not None:
                breaker.reset()
            with self._lock:
                self._down_handled.discard(replica.index)
                self.replica_metrics.pop(replica.index, None)
                self.counters["respawned"] += 1
            self.log(
                f"replica {replica.index} respawned at {addr[0]}:{addr[1]} "
                f"({self.config.max_restarts - self._restarts_used} restarts left)"
            )

    def _sweep_down_replicas(self) -> None:
        """Catch deaths between probes (chaos kill closes the port at once)."""
        for replica in self.replicas:
            if replica.state == DEAD:
                with self._lock:
                    handled = replica.index in self._down_handled
                if not handled:
                    self._handle_replica_down(replica)

    def _chaos_tick(self) -> None:
        """`replica_kill:replica=N` fires once the target is actually
        decoding (mid-stream by construction, so requeue is exercised)."""
        ch = chaos_mod.get()
        if ch is None:
            return
        for replica in self.replicas:
            if replica.state != UP:
                continue
            with self._lock:
                busy = any(
                    e.replica == replica.index and not e.done()
                    and e.snapshot is not None
                    and e.snapshot.get("n_tokens", 0) > 0
                    for e in self._entries.values()
                )
            if busy and ch.replica_kill(replica.index):
                self.log(f"chaos: killing replica {replica.index}")
                replica.kill()

    def _dispatch_pending(self, now: float) -> None:
        while True:
            level = self.brownout.level()
            with self._lock:
                if not self._pending:
                    return
                healthy = self._healthy()
                if not healthy:
                    return
                # breaker gate: open breakers leave the dispatch set; when
                # EVERY candidate is breaker-blocked, fail static to the
                # full healthy set — a breaker sidelines a gray replica, it
                # must never cause a total outage (docs/resilience.md)
                candidates = [
                    r for r in healthy if self.breakers[r.index].ok(now)
                ]
                breaker_gated = bool(candidates)
                if not candidates:
                    candidates = healthy
                cfg = self.config
                # SLO queue-hold, best-effort only: when the best replica
                # projects over budget, fresh best-effort parks here (cheap
                # to cancel/requeue) while premium/standard dispatch and
                # ride the replica-side priority admission + quota floor —
                # the class-blind hold would head-of-line-block premium
                # behind the very flood it needs to outrank
                hold_best_effort = False
                if cfg.slo_ttft_ms is not None and cfg.admission == "queue":
                    proj_min = min(
                        projected_ttft_ms(
                            self._stats_cache.get(r.index, {}),
                            cfg.default_service_ms,
                        )
                        for r in candidates
                    )
                    hold_best_effort = proj_min > cfg.slo_ttft_ms
                # scan for the first dispatchable entry: requeues damped by
                # an exhausted retry budget wait out not_before_ts, and at
                # brownout level >= 2 best-effort parks in the queue while
                # premium/standard behind it still dispatches
                idx = action = None
                for i, rid in enumerate(self._pending):
                    entry = self._entries.get(rid)
                    if entry is None or entry.done():
                        idx, action = i, "drop"
                        break
                    if entry.deadline_ts is not None and now > entry.deadline_ts:
                        idx, action = i, "expire"
                        break
                    if (
                        entry.not_before_ts is not None
                        and now < entry.not_before_ts
                    ):
                        continue
                    if entry.qos == BEST_EFFORT and (
                        level >= 2
                        or (hold_best_effort and entry.state == PENDING)
                    ):
                        continue
                    idx, action = i, "dispatch"
                    break
                if idx is None:
                    return
                rid = self._pending[idx]
                entry = self._entries.get(rid)
                if action == "drop":
                    del self._pending[idx]
                    continue
                if action == "expire":
                    del self._pending[idx]
                    self._finish_local(
                        entry, "expired", "deadline exceeded in router queue"
                    )
                    continue
                # prefix-affinity term (docs/fleet.md "Fleet-global KV"):
                # brownout level >= 2 zeroes the bonus — under overload,
                # raw load beats locality (level was read outside _lock,
                # keeping the brownout lock out of this critical section)
                digest = None
                affinity_ms = 0.0
                if cfg.affinity_weight_ms > 0 and level < 2:
                    prompt = entry.payload.get("prompt") or ()
                    if prompt:
                        digest = PrefixIndex.digest(
                            tuple(int(t) for t in prompt)
                        )
                        affinity_ms = cfg.affinity_weight_ms
                best, proj = self._pick_replica(
                    candidates, digest=digest, affinity_ms=affinity_ms
                )
                if breaker_gated:
                    # probation first: a half-open replica can never win the
                    # latency pick (its cached stats are the slow ones that
                    # tripped it), so the canary dispatch is routed to it
                    # deliberately — one request per cooldown, by the
                    # breaker's single-probe claim
                    for r in candidates:
                        b = self.breakers[r.index]
                        if b.state == BREAKER_HALF_OPEN and b.take_probe(rid):
                            best = r
                            break
                    else:
                        if not self.breakers[best.index].take_probe(rid):
                            # best is half-open with its probe already out:
                            # try the others, else wait the round out
                            remaining = [
                                r for r in candidates if r.index != best.index
                            ]
                            if not remaining:
                                return
                            best, proj = self._pick_replica(
                                remaining, digest=digest,
                                affinity_ms=affinity_ms,
                            )
                            if not self.breakers[best.index].take_probe(rid):
                                return
                entry.not_before_ts = None
                del self._pending[idx]
                # brownout level >= 1: clamp best-effort output length for
                # this dispatch (the entry keeps its full payload, so a
                # requeue after recovery replays unclamped)
                payload = entry.payload
                if (
                    level >= 1
                    and entry.qos == BEST_EFFORT
                    and int(payload.get("max_new", 16)) > cfg.brownout_clamp_tokens
                ):
                    payload = dict(payload, max_new=max(1, cfg.brownout_clamp_tokens))
                    self.counters["brownout_clamped"] += 1
                    self.telemetry.count("fleet.brownout_clamped")
            # milestone BEFORE the downstream round-trip: the replica's own
            # req.queued lands mid-flight, so stamping after the reply
            # would scramble the lane's dispatched→queued ordering
            self.telemetry.event(
                "req.dispatched", trace=entry.trace, rid=entry.rid,
                replica=best.index, resubmits=entry.resubmits,
            )
            remote_id = None
            if self.prefill_workers:
                remote_id = self._dispatch_disaggregated(entry, best, payload)
            if remote_id is None:
                try:
                    remote_id = best.client.submit(**payload)
                except RpcRejectedError as e:
                    self.breakers[best.index].probe_lost(rid)
                    with self._lock:
                        self._finish_local(entry, "failed", str(e))
                    continue
                except (RpcError, OSError) as e:
                    self.breakers[best.index].probe_lost(rid)
                    with self._lock:
                        entry.state = REQUEUED
                        self._pending.appendleft(rid)
                    self._note_failure(best, f"submit: {type(e).__name__}")
                    return
            with self._lock:
                entry.state = ROUTED
                entry.replica = best.index
                entry.remote_id = remote_id
                self.counters["routed"] += 1
                # book the new load locally so picks between probes see it
                cached = self._stats_cache.setdefault(best.index, {})
                cached["queue_depth"] = cached.get("queue_depth", 0) + 1
            self.telemetry.count("fleet.routed")

    def _dispatch_disaggregated(
        self, entry: RouteEntry, best: Replica, payload: Optional[Dict[str, Any]] = None
    ):
        """Disaggregated dispatch (pump thread): run the prompt on a
        prefill replica, hand the KV pack to the chosen decode replica.
        Returns the downstream request id, or None to fall back to plain
        dispatch (prefill fleet down / handoff unsupported) — the decode
        replica's full engine then prefills for itself, so disaggregation
        degrades, never outages. ``payload`` overrides the entry's payload
        when the brownout ladder clamped this dispatch."""
        payload = payload if payload is not None else entry.payload
        worker = pick_worker(self.prefill_workers, self._pw_rr)
        self._pw_rr += 1
        if worker is None:
            return None
        t0 = time.perf_counter()
        try:
            pack = worker.prefill(payload)
        except PrefillWorkerError as e:
            self.log(f"prefill fallback: {e}")
            return None
        with self._lock:
            self.counters["prefilled"] += 1
        self.telemetry.event(
            "req.prefilled", trace=entry.trace, rid=entry.rid,
            replica=worker.index,
            plen=len(payload.get("prompt", [])),
        )
        try:
            remote_id = best.submit_prefilled(payload, pack)
        except Exception as e:  # noqa: BLE001 - dead/remote decode replica: plain dispatch retries
            self.log(f"handoff fallback: {type(e).__name__}: {e}")
            return None
        # handoff latency: prefill dispatch -> KV pack accepted by the
        # decode replica (covers the device_get serialization; the decode
        # side's device put shows up in its serve.kv_admit span)
        handoff_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.counters["handoffs"] += 1
        self.telemetry.gauge("serve.handoff_ms", handoff_ms)
        self.telemetry.histogram("serve.handoff_ms", handoff_ms)
        self.telemetry.event(
            "req.handoff", trace=entry.trace, rid=entry.rid,
            prefill_replica=worker.index, decode_replica=best.index,
            handoff_ms=round(handoff_ms, 3),
        )
        return remote_id

    def _poll_routed(self) -> None:
        with self._lock:
            live = [
                (e.rid, e.replica, e.remote_id, e.cancel_requested, e.cancel_sent)
                for e in self._entries.values()
                if e.state == ROUTED and not e.done()
            ]
        for rid, idx, remote_id, want_cancel, cancel_sent in live:
            replica = self._replica(idx)
            if replica is None or replica.state != UP:
                continue  # the down-sweep requeues; don't poke a closed port
            try:
                if want_cancel and not cancel_sent:
                    replica.client.cancel(remote_id)
                    with self._lock:
                        entry = self._entries.get(rid)
                        if entry is not None:
                            entry.cancel_sent = True
                snap = replica.client.poll(remote_id)
            except RpcRejectedError:
                # replica forgot the id (restart/retention): replay it,
                # charged against the replica's retry budget
                self.breakers[idx].probe_lost(rid)
                now = time.time()
                requeued_entry = None
                with self._lock:
                    entry = self._entries.get(rid)
                    if entry is not None and not entry.done():
                        entry.state = REQUEUED
                        entry.replica = None
                        entry.remote_id = None
                        entry.snapshot = None
                        entry.resubmits += 1
                        budget = self.retry_budgets.get(idx)
                        if budget is not None and not budget.consume(now):
                            entry.not_before_ts = now + 0.25 * entry.resubmits
                            self.counters["retry_deferred"] += 1
                            self.telemetry.count("fleet.retry_deferred")
                        self.counters["requeued"] += 1
                        self._pending.appendleft(rid)
                        requeued_entry = entry
                if requeued_entry is not None:
                    self.telemetry.event(
                        "req.requeued", trace=requeued_entry.trace, rid=rid,
                        replica=idx, resubmits=requeued_entry.resubmits,
                    )
                continue
            except (RpcError, OSError) as e:
                self.breakers[idx].probe_lost(rid)
                self._note_failure(replica, f"poll: {type(e).__name__}")
                return
            # gray-failure probation: the probe's first observed TTFT is
            # the verdict (the breaker ignores every other rid)
            if snap.get("ttft_ms") is not None:
                verdict = self.breakers[idx].observe_ttft(
                    rid, float(snap["ttft_ms"]), time.time()
                )
                if verdict == "closed":
                    self.telemetry.count("fleet.breaker_closed")
                    self.log(
                        f"breaker CLOSED on replica {idx} (probe ttft "
                        f"{snap['ttft_ms']:.0f}ms)"
                    )
                    # capacity just came online: spread any backlog that
                    # was pinned to the overloaded peers before this
                    # replica could take weighted traffic
                    self.rebalance_excess()
                elif verdict == "reopened":
                    self.telemetry.count("fleet.breaker_opened")
                    self.log(
                        f"breaker RE-OPENED on replica {idx} (probe ttft "
                        f"{snap['ttft_ms']:.0f}ms)"
                    )
            completed = None
            with self._lock:
                entry = self._entries.get(rid)
                if entry is None or entry.state != ROUTED:
                    continue
                entry.snapshot = snap
                if snap.get("done") and not entry.counted_done:
                    entry.counted_done = True
                    key = {
                        "done": "completed",
                        "cancelled": "cancelled",
                        "expired": "expired",
                        "failed": "failed",
                    }.get(snap.get("state"), "completed")
                    self.counters[key] += 1
                    completed = entry
                    # exact fleet-edge SLO attainment, judged on the TTFT
                    # the serving replica measured for this request, split
                    # per QoS class for the no-cliff view
                    if (
                        self.config.slo_ttft_ms is not None
                        and snap.get("ttft_ms") is not None
                    ):
                        by_class = self.slo_by_class.get(entry.qos)
                        if snap["ttft_ms"] <= self.config.slo_ttft_ms:
                            self.slo_ok += 1
                            if by_class is not None:
                                by_class["ok"] += 1
                        else:
                            self.slo_miss += 1
                            if by_class is not None:
                                by_class["miss"] += 1
            if completed is not None:
                self.telemetry.event(
                    "req.completed", trace=completed.trace, rid=rid,
                    state=snap.get("state"), replica=idx,
                    resubmits=completed.resubmits,
                )
