"""QoS-aware request scheduler and the engine loop.

A copy of :mod:`maggy_tpu.serve.scheduler` over the port's engine. The loop
thread makes the engine's card current before it touches the engine (CUDA's
current device is per host thread), and ``autopilot=`` raises until the
autopilot is ported (ROADMAP queue 1 item 9).

One daemon thread owns the engine: it admits queued requests whenever slots
free up (prefill interleaved with decode) — highest QoS class first, FIFO
within a class, bounded by the weighted token quotas in
:mod:`maggy_tpu_torch.serve.qos` — decodes one token per active slot per
iteration, and retires requests on EOS / ``max_new`` / cancellation /
deadline. RPC handlers only touch the queue and request index under the
scheduler lock — they never block on device work, which keeps the asyncio
socket loop responsive while the device crunches.

Telemetry (continuously, into the ambient or provided recorder):
``serve.queue_depth``, ``serve.active_slots``, ``serve.tokens_per_sec``
(EMA over loop iterations), ``serve.ttft_ms`` per admission,
``serve.drain_ms`` (host-blocked time per async token drain —
docs/performance.md), and the engine's retrace gauges. Counters:
``serve.requests_{submitted,done,cancelled,expired,failed,rejected}`` and
``serve.tokens_out``.

Request-scoped observability (docs/observability.md): every request carries
a trace id (from the SUBMIT frame, else minted here) and emits lifecycle
events under it — ``req.queued`` → ``req.admitted``/``req.prefix_admitted``
→ ``req.first_token`` → ``req.finished`` — while fixed-log-bucket
histograms aggregate TTFT, TPOT, queue-wait, and e2e latency
(scheduler-owned, for SSTATS percentiles and the router's fleet-level
merge; mirrored into the recorder for JSONL/monitor snapshots). The engine
loop arms a ``serve.loop`` stall-watchdog mark, so a wedged step loop dumps
the flight recorder instead of dying silently.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from maggy_tpu_torch import telemetry
from maggy_tpu_torch.core import lockdebug
from maggy_tpu_torch.exceptions import BadArgumentsError
from maggy_tpu_torch.resilience import chaos as chaos_mod
from maggy_tpu_torch.serve import request as rq
from maggy_tpu_torch.serve.engine import Engine
from maggy_tpu_torch.serve.paging import OutOfPagesError
from maggy_tpu_torch.serve.qos import (
    DEFAULT_TENANT,
    QOS_CLASSES,
    QOS_PRIORITY,
    QosQueue,
    QuotaLedger,
    validate_qos,
)
from maggy_tpu_torch.serve.request import Request, SamplingParams
from maggy_tpu_torch.telemetry import flightrec, timeseries, tracing
from maggy_tpu_torch.telemetry.alerts import AlertEvaluator, RecompileSentinel
from maggy_tpu_torch.telemetry.profcap import ProfileCapture
from maggy_tpu_torch.telemetry.histogram import LatencyHistogram

# the latency signals the scheduler aggregates (histogram per signal);
# SSTATS exposes raw buckets under "latency" plus derived percentiles
LATENCY_SIGNALS = ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms")

# terminal requests stay pollable this long after finishing
RETENTION_S = 300.0
# idle wait when nothing is queued or active
IDLE_WAIT_S = 0.02


class Scheduler:
    def __init__(
        self,
        engine: Engine,
        max_queue: int = 1024,
        telemetry_recorder=None,
        retention_s: float = RETENTION_S,
        slo_ttft_ms: Optional[float] = None,
        autopilot=None,
        qos_weights: Optional[Dict[str, float]] = None,
        qos_window_s: float = 5.0,
    ):
        self.engine = engine
        self.max_queue = max_queue
        self.retention_s = retention_s
        self.telemetry = telemetry_recorder or engine.telemetry or telemetry.get()
        # autopilot (docs/autotune.md "Continuous tuning"): an
        # AutopilotConfig/True attaches an online controller the loop ticks;
        # slot-geometry moves land through request_reconfigure below
        self._pending_slots: Optional[int] = None
        self.autopilot = None
        if autopilot is not None and autopilot is not False:
            raise NotImplementedError(
                "the serving autopilot is not ported yet (ROADMAP queue 1 item 9)"
            )
        self._lock = lockdebug.rlock("scheduler._lock")
        self._wake = threading.Condition(self._lock)
        # class-ordered admission queue (docs/fleet.md "QoS classes"):
        # priority then arrival within a class; preemption/backpressure
        # requeues go to the front of their own class
        self._queue = QosQueue()  # guarded-by: _lock
        # weighted decode-token quotas; the loop charges per emitted token,
        # admission defers over-share classes while others wait
        self.quota = QuotaLedger(weights=qos_weights, window_s=qos_window_s)
        # per-class lifetime counts (admitted/preempted/quota_deferred),
        # mirrored as serve.qos.* counters and in the stats() qos block
        self.qos_counters: Dict[str, Dict[str, int]] = {
            c: {"admitted": 0, "preempted": 0, "quota_deferred": 0}
            for c in QOS_CLASSES
        }  # guarded-by: _lock
        # which fleet replica this scheduler serves (set by Replica.start);
        # the replica_slow chaos seam keys on it to make one replica gray
        self.replica_index: Optional[int] = None
        self._requests: Dict[str, Request] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # scheduler-owned latency histograms (replacing the old 512-entry
        # TTFT deque): unbounded sample count, O(1) observe, mergeable at
        # the router. Written by the loop thread, serialized in stats()
        # under the lock.
        self._hist: Dict[str, LatencyHistogram] = {
            name: LatencyHistogram() for name in LATENCY_SIGNALS
        }
        # SLO attainment: exact per-request TTFT-vs-budget counters when an
        # SLO is configured (the fleet router sets its own from RouterConfig)
        self.slo_ttft_ms = None if slo_ttft_ms is None else float(slo_ttft_ms)
        self.slo_ok = 0
        self.slo_miss = 0
        self._started_ts = time.time()
        self._tok_rate_ema = 0.0
        # paged-cache preemptions enacted (docs/serving.md "Preemption") —
        # not a terminal state: the preempted request completes later
        self.preemptions = 0
        self.counters: Dict[str, int] = {
            "submitted": 0,
            "done": 0,
            "cancelled": 0,
            "expired": 0,
            "failed": 0,
            "rejected": 0,
        }
        # observability tick state (docs/observability.md "Time series"):
        # the loop samples the recorder into bounded ring-buffer series on
        # the ~1 s flush cadence, evaluates the checked-in alert rules at
        # worker scope, and the sentinel watches engine compile counts for
        # retraces outside a reconfigure window
        self.metrics = timeseries.SeriesStore()
        self.alerts = AlertEvaluator(self.metrics, self.telemetry, scope="worker")
        self.sentinel = RecompileSentinel(
            self.metrics, self.telemetry, scope="worker", steady=("decode", "admit")
        )
        # capacity observability (docs/observability.md "Capacity"): the
        # engine's memory ledger reconciles on the same tick, and a watched
        # critical alert arms a bounded profile capture beside the
        # flight-recorder dumps (telemetry/profcap.py)
        self.memory = engine.memory
        self.profcap = ProfileCapture(device=engine.device)
        # last ticked headroom, stamped on admission events for trace
        # attribution (headroom_at_admit); loop thread writes, loop reads
        self._last_headroom_pct: Optional[float] = None

    # ------------------------------------------------------------- public API
    # (called from RPC handler threads; must not block on device work)

    def submit(
        self,
        prompt: List[int],
        params: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        trace: Optional[str] = None,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
        _pack: Optional[Dict[str, Any]] = None,
    ) -> Request:
        params = params or SamplingParams()
        params.validate()
        try:
            qos = validate_qos(qos)
        except ValueError as e:
            raise BadArgumentsError(str(e)) from None
        if not prompt:
            raise BadArgumentsError("empty prompt")
        if len(prompt) + params.max_new > self.engine.max_seq_len:
            raise BadArgumentsError(
                f"prompt ({len(prompt)}) + max_new ({params.max_new}) "
                f"exceeds max_seq_len ({self.engine.max_seq_len})"
            )
        engine = self.engine
        if engine.paged:
            # a request that can NEVER fit the pool is a config error and
            # fails fast; anything that fits eventually is admitted
            # eventually (backpressure/preemption, never a refusal)
            worst = -(-(len(prompt) + params.max_new) // engine.page_size)
            cap = min(engine.max_pages_per_req, engine.allocator.pages_total)
            if worst > cap:
                raise BadArgumentsError(
                    f"request needs up to {worst} KV pages > cap {cap} "
                    f"(page_size {engine.page_size}; raise "
                    "max_pages_per_req or the pool)"
                )
        req = Request(prompt=[int(t) for t in prompt], params=params,
                      prefilled=_pack, qos=qos,
                      tenant=str(tenant) if tenant else DEFAULT_TENANT)
        # adopt the caller's trace id (SUBMIT frame / ambient RPC scope) so
        # the request's lifecycle correlates with its client-side journey;
        # direct in-process submits get a fresh one
        req.trace = trace or tracing.ensure()
        if deadline_s is not None:
            req.deadline_ts = time.time() + float(deadline_s)
        with self._wake:
            if len(self._queue) >= self.max_queue:
                self.counters["rejected"] += 1
                raise BadArgumentsError(
                    f"queue full ({self.max_queue} requests waiting)"
                )
            self._queue.append(req)
            self._requests[req.id] = req
            self.counters["submitted"] += 1
            self._wake.notify_all()
        self.telemetry.event(
            "req.queued", trace=req.trace, rid=req.id,
            plen=len(req.prompt), max_new=params.max_new,
            tenant=req.tenant, qos=req.qos,
        )
        return req

    def submit_prefilled(
        self,
        prompt: List[int],
        params: Optional[SamplingParams],
        pack: Dict[str, Any],
        deadline_s: Optional[float] = None,
        trace: Optional[str] = None,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
    ) -> Request:
        """Disaggregated handoff entry (docs/fleet.md "Disaggregated
        prefill/decode"): like :meth:`submit`, but the prompt's KV was
        already computed by a prefill replica and rides in ``pack``
        (:meth:`Engine.prefill_only`'s host-resident row). Admission writes
        the pack into the cache instead of prefilling; everything after
        the first token is the ordinary decode path."""
        return self.submit(
            prompt, params, deadline_s=deadline_s, trace=trace,
            tenant=tenant, qos=qos, _pack=dict(pack),
        )

    def poll(self, request_id: str) -> Dict[str, Any]:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                raise BadArgumentsError(f"unknown request {request_id!r}")
            return req.snapshot()

    def cancel(self, request_id: str) -> bool:
        """Flag a request for cancellation; the loop enacts it at the next
        boundary (queued requests die before admission, running ones are
        evicted after the in-flight step). Returns False for terminal or
        unknown requests."""
        with self._wake:
            req = self._requests.get(request_id)
            if req is None or req.state in rq.TERMINAL:
                return False
            req.cancel_requested = True
            self._wake.notify_all()
            return True

    def request_reconfigure(self, num_slots: int) -> bool:
        """Ask for a new slot geometry (the autopilot's ``serve.num_slots``
        safe-live move). Applied by the engine loop at the next wave
        boundary: admission pauses, the active set drains naturally, the
        engine rebuilds (compile warmed inside), then admission resumes —
        queued requests wait, nothing is dropped."""
        num_slots = int(num_slots)
        if num_slots < 1:
            return False
        with self._wake:
            if num_slots == self.engine.slots.num_slots:
                self._pending_slots = None
                return True
            self._pending_slots = num_slots
            self._wake.notify_all()
        return True

    def reconfigure_pending(self) -> bool:
        """True while a requested slot-geometry change awaits the drain."""
        with self._lock:
            return self._pending_slots is not None

    def _maybe_reconfigure(self) -> None:
        """Apply a pending slot change once the active set has drained
        (loop thread only)."""
        with self._lock:
            target = self._pending_slots
        if target is None or self.engine.slots.active_count:
            return
        try:
            # a reconfigure legitimately recompiles decode/admit: tell the
            # sentinel so the count bump re-baselines instead of alerting
            self.sentinel.expect()
            self.engine.reconfigure(target)
        except Exception as e:  # noqa: BLE001 - a failed re-tune must not kill serving
            self.telemetry.event(
                "autopilot.reconfigure_failed",
                num_slots=target, error=f"{type(e).__name__}: {e}",
            )
        with self._lock:
            # compare-and-clear: a newer slot request that landed while this
            # reconfigure ran must not be silently clobbered
            if self._pending_slots == target:
                self._pending_slots = None

    def _metrics_tick(self, now: float, wd=None) -> None:
        """One observability tick (loop thread, ~1 Hz with the flush):
        reconcile the capacity ledger, sample the recorder into the series
        rings, ingest the SLO counters, feed compile counts to the
        sentinel, run the alert rules, and hand the alert transitions to
        the profile-capture controller."""
        # capacity gauges go out BEFORE the sample so they land in this
        # tick's series points (heat/fragmentation ride the recorder; the
        # ledger ingests its mem.* series and burn counters directly)
        eng = self.engine
        tel = self.telemetry
        mem = self.memory.tick(store=self.metrics, telemetry=tel, now=now)
        self._last_headroom_pct = mem.get("headroom_pct") if mem else None
        if eng.paged:
            heat = eng.allocator.heat_buckets(eng.steps)
            frag = eng.allocator.fragmentation()
            tel.gauge("serve.pages_hot", heat["hot"])
            tel.gauge("serve.pages_warm", heat["warm"])
            tel.gauge("serve.pages_cold", heat["cold"])
            tel.gauge("serve.fragmentation", frag["frag_ratio"])
        res = eng.prefix_index.residency_stats(gen=eng.steps)
        tel.gauge("serve.prefix_resident_bytes", res["resident_bytes"])
        tel.gauge("serve.prefix_resident_count", res["resident_prefixes"])
        if eng.tier is not None:
            # pressure spill (docs/serving.md "Host-DRAM page tier"): when
            # reconciled HBM headroom sits under the tier's low-water mark,
            # preempt-with-spill the coldest low-class stream — at most one
            # per tick — freeing pool pages BEFORE an admission runs the
            # allocator dry and has to preempt under the gun
            if eng.tier_policy.should_spill(self._last_headroom_pct):
                self._drain_inflight()
                actives = eng.slots.active_slots()
                if actives:

                    def _rank(slot: int):
                        r = eng.slots.get(slot).request
                        return (QOS_PRIORITY.get(r.qos, len(QOS_CLASSES)),
                                r.admitted_ts or 0.0, slot)

                    self._preempt_victim(
                        max(actives, key=_rank), False, pressure=True
                    )
            ts = eng.tier.stats()
            tel.gauge("tier.host_pages_free", ts["host_pages_free"])
            tel.gauge("tier.host_pages_total", ts["host_pages_total"])
            tel.gauge("tier.host_bytes", ts["host_bytes"])
            tel.gauge("tier.resident_packs", ts["resident_packs"])
        self.metrics.sample(self.telemetry, now)
        if self.slo_ttft_ms is not None:
            with self._lock:
                slo_ok, slo_miss = self.slo_ok, self.slo_miss
            self.metrics.ingest(
                now,
                counters={
                    "serve.slo_ok": slo_ok,
                    "serve.slo_miss": slo_miss,
                },
            )
        self.sentinel.observe(self.engine.compile_counts, now, watchdog=wd)
        transitions = self.alerts.evaluate(now, watchdog=wd)
        if self.profcap.dump_dir is None and getattr(wd, "dump_dir", None):
            self.profcap.configure(dump_dir=wd.dump_dir)
        self.profcap.tick(transitions, now=now)
        self.telemetry.gauge(
            "alerts.firing", len(self.alerts.firing()) + len(self.sentinel.firing())
        )

    def stats(self) -> Dict[str, Any]:
        """One consistent snapshot, built entirely under the scheduler lock.

        The router polls SSTATS concurrently with the engine loop; every
        mutable structure read here (queue, counters, histograms) is copied
        while the lock is held so a mid-iteration mutation can never tear the
        snapshot (dict-changed-size during iteration) or mix counters from
        two different instants. Engine counters are plain ints the scheduler
        thread owns — single reads are atomic under the GIL.

        Latency surfaces: derived percentiles (``ttft_ms_p50/p90/p95/p99``,
        ``tpot_ms_p50/p95``, ``queue_wait_ms_p50``, ``e2e_ms_p50/p95``) plus
        the raw bucket encodings under ``latency`` — the router merges those
        bucket-wise into fleet-level distributions. With ``slo_ttft_ms``
        set, ``slo_ok``/``slo_miss``/``slo_attainment`` report SLO health."""
        with self._lock:
            counters = dict(self.counters)
            queue_depth = len(self._queue)
            hists = {name: h.copy() for name, h in self._hist.items()}
            slo = (self.slo_ttft_ms, self.slo_ok, self.slo_miss)
            engine = self.engine
            snap = {
                "queue_depth": queue_depth,
                "active_slots": engine.slots.active_count,
                "num_slots": engine.slots.num_slots,
                "tokens_out": engine.tokens_out,
                "tokens_per_sec": round(self._tok_rate_ema, 2),
                "steps": engine.steps,
                "uptime_s": round(time.time() - self._started_ts, 3),
                "compile_counts": engine.compile_counts,
                "paging": engine.paging_stats,
                "preemptions": self.preemptions,
                # capacity view: ledger reconciliation + profile-capture
                # controller state (docs/observability.md "Capacity")
                "memory": self.memory.snapshot(),
                "profcap": self.profcap.snapshot(),
                # host-DRAM KV tier view (docs/serving.md "Host-DRAM page
                # tier"): pool occupancy + the spill/fill ledger
                "tier": engine.tier_stats,
                # per-class QoS view (docs/fleet.md "QoS classes"): queue
                # depths, lifetime admission/preempt/defer counts, and the
                # quota ledger's windowed token shares
                "qos": {
                    "queued": self._queue.depths(),
                    "counters": {
                        c: dict(v) for c, v in self.qos_counters.items()
                    },
                    "quota": self.quota.snapshot(),
                },
                **engine.prefix_stats,
            }
        ttft = hists["ttft_ms"]
        snap["ttft_ms_p50"] = ttft.percentile(0.50)
        snap["ttft_ms_p90"] = ttft.percentile(0.90)
        snap["ttft_ms_p95"] = ttft.percentile(0.95)
        snap["ttft_ms_p99"] = ttft.percentile(0.99)
        snap["tpot_ms_p50"] = hists["tpot_ms"].percentile(0.50)
        snap["tpot_ms_p95"] = hists["tpot_ms"].percentile(0.95)
        snap["queue_wait_ms_p50"] = hists["queue_wait_ms"].percentile(0.50)
        snap["e2e_ms_p50"] = hists["e2e_ms"].percentile(0.50)
        snap["e2e_ms_p95"] = hists["e2e_ms"].percentile(0.95)
        snap["latency"] = {name: h.to_dict() for name, h in hists.items()}
        slo_ms, ok, miss = slo
        if slo_ms is not None:
            snap["slo_ttft_ms"] = slo_ms
            snap["slo_ok"] = ok
            snap["slo_miss"] = miss
            snap["slo_attainment"] = ok / (ok + miss) if (ok + miss) else None
        snap.update({f"requests_{k}": v for k, v in counters.items()})
        snap["alerts"] = self.alerts.firing() + self.sentinel.firing()
        if self.autopilot is not None:
            snap["autopilot"] = self.autopilot.status()
        return snap

    # -------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="maggy-serve-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until queue and slots are empty (tests/CLI shutdown)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if not self._queue and self.engine.slots.active_count == 0:
                    return True
            time.sleep(0.005)
        return False

    # ------------------------------------------------------------ engine loop

    def _finish(  # guarded-by: _lock
        self, req: Request, state: str, error: Optional[str] = None
    ) -> None:
        req.finish(state, error)
        key = {
            rq.DONE: "done",
            rq.CANCELLED: "cancelled",
            rq.EXPIRED: "expired",
            rq.FAILED: "failed",
        }[state]
        self.counters[key] += 1
        tel = self.telemetry
        tel.count(f"serve.requests_{key}")
        if req.e2e_ms is not None:
            self._hist["e2e_ms"].observe(req.e2e_ms)
            tel.histogram("serve.e2e_ms", req.e2e_ms)
        if req.tpot_ms is not None:
            self._hist["tpot_ms"].observe(req.tpot_ms)
            tel.histogram("serve.tpot_ms", req.tpot_ms)
        # trace attribution v2: the request's high-water page count rides
        # the finish event (the slot is still resident here — release runs
        # after the finish on every exit path)
        peak = None
        eng = self.engine
        if eng.paged:
            for s in eng.slots.active_slots():
                if eng.slots.get(s).request is req:
                    peak = eng.pages_held_peak(s)
                    break
        tel.event(
            "req.finished", trace=req.trace, rid=req.id, state=state,
            n_tokens=len(req.tokens), e2e_ms=req.e2e_ms,
            pages_held_peak=peak,
        )

    def _emit(self, req: Request, token: int, now: float) -> bool:  # guarded-by: _lock
        """Append a generated token; True when the request just finished."""
        req.tokens.append(int(token))
        # quota accounting: one windowed decode token against the class
        self.quota.charge(req.qos, 1, now)
        if req.first_token_ts is None:
            req.first_token_ts = now
            ttft = req.ttft_ms
            if ttft is not None:
                self._hist["ttft_ms"].observe(ttft)
                tel = self.telemetry
                tel.gauge("serve.ttft_ms", ttft)
                tel.histogram("serve.ttft_ms", ttft)
                tel.event(
                    "req.first_token", trace=req.trace, rid=req.id, ttft_ms=ttft
                )
                if self.slo_ttft_ms is not None:
                    if ttft <= self.slo_ttft_ms:
                        self.slo_ok += 1
                    else:
                        self.slo_miss += 1
        p = req.params
        if (p.eos_id >= 0 and int(token) == p.eos_id) or len(req.tokens) >= p.max_new:
            self._finish(req, rq.DONE)
            return True
        return False

    def _admit_ready(self, now: float) -> None:
        """Admit queued requests into free slots — priority class first,
        FIFO within a class, quota-deferred classes skipped while another
        class waits under share; drop dead ones.

        A dry page pool (:class:`OutOfPagesError`) is BACKPRESSURE, not
        failure: the head request goes back to the front of its class and
        admission pauses until running requests finish or preemption frees
        pages — no request is ever refused for memory pressure (only a
        request that could never fit fails, at submit). A waiting class
        that strictly outranks an active row never waits for natural
        turnover, though: it preempts the lowest-class youngest row
        (slot AND pages), so premium TTFT is bounded by a prefill, not
        by a victim's remaining decode."""
        with self._lock:
            if self._pending_slots is not None:
                return  # drain-and-reconfigure in progress: let the wave empty
        while True:
            if not self.engine.slots.free_slots():
                with self._lock:
                    waiting = self._queue.classes_waiting()
                if not waiting or not self._preempt_lower_class(waiting[0]):
                    return
            with self._lock:
                req, deferred = self._queue.pop_next(self.quota, now)
                if req is None:
                    return
                for cls in deferred:
                    self.qos_counters[cls]["quota_deferred"] += 1
            for cls in deferred:
                self.telemetry.count(f"serve.qos.quota_deferred.{cls}")
            # replica_slow chaos seam (docs/resilience.md "Gray failure"):
            # a gray replica is alive but slow — inject the latency on the
            # admission path, outside the lock, so its own TTFT histograms
            # (what the router's breaker scores) absorb the slowness
            ch = chaos_mod.get()
            if ch is not None:
                slow_s = ch.replica_slow(self.replica_index)
                if slow_s > 0:
                    # a gray replica, not a gray card: the loop's pass holds
                    # the host lock, which the card's other engines wait on
                    self.engine.host_lock.release()
                    try:
                        time.sleep(slow_s)
                    finally:
                        self.engine.host_lock.acquire()
            if req.cancel_requested:
                with self._lock:
                    self._finish(req, rq.CANCELLED)
                continue
            if req.deadline_ts is not None and now > req.deadline_ts:
                with self._lock:
                    self._finish(req, rq.EXPIRED, "deadline exceeded in queue")
                continue
            # admission milestone BEFORE the prefill device work, so the
            # trace lane's queued→admitted gap is pure queue wait and
            # admitted→first_token is the prefill (docs/observability.md);
            # the prefix decision is re-read from the same deterministic
            # index match admit() itself will make
            req.admitted_ts = time.time()
            wait_ms = req.queue_wait_ms
            prefix_hit = (
                req.prefilled is None
                and self.engine._match_prefix(
                    list(req.prompt) + list(req.tokens)
                )
                is not None
            )
            tel = self.telemetry
            if wait_ms is not None:
                self._hist["queue_wait_ms"].observe(wait_ms)
                tel.histogram("serve.queue_wait_ms", wait_ms)
            tel.event(
                "req.prefix_admitted" if prefix_hit else "req.admitted",
                trace=req.trace, rid=req.id, queue_wait_ms=wait_ms,
                headroom_at_admit=self._last_headroom_pct,
            )
            pack, req.prefilled = req.prefilled, None
            admitted = False
            while True:
                try:
                    # the request's trace becomes ambient for the admission,
                    # so the engine's prefill/prefix-admit spans correlate
                    with tracing.scope(req.trace):
                        if pack is not None:
                            slot, first = self.engine.admit_from_kv(req, pack)
                        else:
                            slot, first = self.engine.admit(req)
                    admitted = True
                except OutOfPagesError:
                    # a dry pool must not park a higher class behind
                    # lower-class decodes: preempt strictly-lower-class
                    # rows (lowest class, youngest first) until the
                    # admission fits. Only same-or-higher-class occupancy
                    # backpressures — then the head request goes back to
                    # the front of its class (ahead of its peers; higher
                    # classes still outrank it next round), keeping its
                    # disaggregated-prefill pack for the next attempt
                    if self._preempt_lower_class(req.qos):
                        continue
                    req.prefilled = pack
                    with self._wake:
                        self._queue.requeue_front(req)
                    return
                except Exception as e:  # noqa: BLE001 - a poison request must not kill the loop
                    with self._lock:
                        self._finish(req, rq.FAILED, f"{type(e).__name__}: {e}")
                break
            if not admitted:
                continue
            with self._lock:
                req.state = rq.RUNNING
                self.qos_counters[req.qos]["admitted"] += 1
                if self._emit(req, first, time.time()):
                    self._release_slot(slot)
            tel.count(f"serve.qos.admitted.{req.qos}")

    def _release_slot(self, slot: int) -> None:
        """THE slot-vacating seam: every exit path (finish at emit, cancel,
        deadline, preemption) releases cache resources — pages, prefix
        anchor, slot row — through the engine's one release method. The
        cancel-storm regression in test_serve_engine.py asserts nothing
        leaks whichever path fires."""
        self.engine.release(slot)

    def _finish_active(
        self, slot: int, req: Request, state: str, error: Optional[str] = None
    ) -> None:
        """Finish an in-slot request and release its resources — the shared
        cancel/expire path (the emit path finishes inside ``_emit`` and
        releases through the same ``_release_slot``)."""
        with self._lock:
            self._finish(req, state, error)
        self._release_slot(slot)

    def _sweep_active(self, now: float) -> None:
        """Evict running requests whose cancel flag or deadline fired."""
        for slot in list(self.engine.slots.active_slots()):
            req = self.engine.slots.get(slot).request
            if req.cancel_requested:
                self._finish_active(slot, req, rq.CANCELLED)
            elif req.deadline_ts is not None and now > req.deadline_ts:
                self._finish_active(
                    slot, req, rq.EXPIRED, "deadline exceeded while decoding"
                )

    def _drain_inflight(self) -> None:
        """Flush the async double buffer and emit what it held (preemption
        prelude: the in-flight tokens may finish requests and free pages)."""
        out = self.engine.flush()
        now = time.time()
        for slot, token in out.tokens.items():
            req = self.engine.slots.get(slot).request
            with self._lock:
                finished = self._emit(req, token, now)
            if finished:
                self._release_slot(slot)

    def _preempt_for_pages(self) -> None:
        """Paged decode ran the allocator dry (an active row crossed a page
        boundary with no free page): preempt the LOWEST-PRIORITY active
        request, youngest within the class (PR 10's preempt-youngest is the
        degenerate single-class case) — free its pages, requeue it at the
        front of its class with prompt AND generated tokens retained — until
        every remaining row can grow. Re-admission resumes the stream
        byte-identically (docs/serving.md "Preemption"); the PRNG-chain
        resume seam is untouched by the victim-ordering change, so a
        preempted premium stream still completes bit-exact."""
        if not self.engine.paged:
            return
        while self.engine.prepare_step():
            # in-flight tokens first: a finish is cheaper than a preempt
            self._drain_inflight()
            if not self.engine.prepare_step():
                return
            actives = self.engine.slots.active_slots()
            if not actives:
                return

            def _rank(slot: int):
                r = self.engine.slots.get(slot).request
                # max() picks: largest priority number (lowest class), then
                # most recent admission (youngest) within the class
                return (QOS_PRIORITY.get(r.qos, len(QOS_CLASSES)),
                        r.admitted_ts or 0.0, slot)

            victim = max(actives, key=_rank)
            req = self.engine.slots.get(victim).request
            # a victim chosen BY class (some active row outranks it) is a
            # priority preemption, not just the youngest of equals
            vp = QOS_PRIORITY.get(req.qos, len(QOS_CLASSES))
            for_priority = any(
                QOS_PRIORITY.get(self.engine.slots.get(s).request.qos, 0) < vp
                for s in actives if s != victim
            )
            self._preempt_victim(victim, for_priority)

    def _preempt_victim(
        self, victim: int, for_priority: bool, pressure: bool = False
    ) -> None:
        """THE victim seam shared by decode-growth, admission, and
        tier-pressure preemption: spill the victim's KV to the host tier
        (when one is attached — re-admission then swaps in instead of
        re-prefilling), release the slot (pages, anchor, row) through
        ``_release_slot``, requeue the request at the front of its class
        with prompt AND generated tokens retained, and account it — the
        byte-identical resume guarantee lives entirely in this one path."""
        req = self.engine.slots.get(victim).request
        if self.engine.tier is not None:
            try:
                self.engine.spill_stream(victim, pressure=pressure)
            except Exception:  # noqa: BLE001 - spill is best-effort; preempt must proceed
                pass
        self._release_slot(victim)
        with self._wake:
            req.state = rq.QUEUED
            req.preemptions += 1
            self._queue.requeue_front(req)
            self.preemptions += 1
            self.qos_counters[req.qos]["preempted"] += 1
        tel = self.telemetry
        tel.count("serve.preemptions")
        tel.count(f"serve.qos.preempted.{req.qos}")
        tel.event(
            "req.preempted", trace=req.trace, rid=req.id,
            n_tokens=len(req.tokens), preemptions=req.preemptions,
        )
        if for_priority:
            tel.event(
                "req.preempted_for_priority", trace=req.trace, rid=req.id,
                qos=req.qos, n_tokens=len(req.tokens),
            )

    def _preempt_lower_class(self, qos: str) -> bool:
        """Free capacity (a slot and its pages) for a waiting higher-class
        admission: preempt the active row QOS strictly outranks — lowest
        class first, youngest within the class — and report whether
        admission should retry. In-flight tokens drain first (a finish is
        cheaper than a preempt, and may free the capacity by itself). A
        same-class squeeze never preempts: FIFO-within-class backpressure
        stays livelock-free."""
        if not self.engine.paged:
            return False
        had_free = self.engine.slots.free_slots()
        self._drain_inflight()
        if self.engine.slots.free_slots() > had_free:
            return True  # a finish freed slot + pages without a victim
        rp = QOS_PRIORITY.get(qos, len(QOS_CLASSES))
        victims = [
            s for s in self.engine.slots.active_slots()
            if QOS_PRIORITY.get(
                self.engine.slots.get(s).request.qos, len(QOS_CLASSES)
            ) > rp
        ]
        if not victims:
            return False

        def _rank(slot: int):
            r = self.engine.slots.get(slot).request
            return (QOS_PRIORITY.get(r.qos, len(QOS_CLASSES)),
                    r.admitted_ts or 0.0, slot)

        self._preempt_victim(max(victims, key=_rank), for_priority=True)
        return True

    def _retire_old(self, now: float) -> None:
        with self._lock:
            dead = [
                rid
                for rid, r in self._requests.items()
                if r.done_ts is not None and now - r.done_ts > self.retention_s
            ]
            for rid in dead:
                del self._requests[rid]

    def _loop(self) -> None:
        if self.engine.device.type == "cuda":
            # CUDA's current device is per host thread: without this an
            # engine on cuda:1 would allocate its temporaries on cuda:0
            torch.cuda.set_device(self.engine.device)
        tel = self.telemetry
        last_flush = time.time()
        # stall watchdog: the loop beats every iteration (including idle
        # waits); a wedged engine step stops the beats and dumps the flight
        # recorder instead of hanging silently (docs/observability.md)
        wd = flightrec.get()
        wd.begin("serve.loop")
        try:
            self._loop_body(tel, last_flush, wd)
        finally:
            wd.end("serve.loop")

    def _pass(self, tel) -> bool:
        """Sweep, admit, preempt and take one decode step; False when no
        slot is active (the loop then waits for work)."""
        now = time.time()
        self._sweep_active(now)
        self._maybe_reconfigure()
        self._admit_ready(now)
        if self.autopilot is not None:
            self.autopilot.maybe_sample(now)

        self._preempt_for_pages()
        active = self.engine.slots.active_slots()
        if not active:
            # async decode leaves the last dispatch in flight when the
            # active set empties (its rows all belong to finished
            # requests); retire it so no device refs linger across idle
            self.engine.flush()
            return False
        t0 = time.perf_counter()
        out = self.engine.step()
        dt = time.perf_counter() - t0
        now = time.time()
        for slot, token in out.tokens.items():
            req = self.engine.slots.get(slot).request
            with self._lock:
                finished = self._emit(req, token, now)
            if finished:
                self._release_slot(slot)
        rate = len(out.tokens) / dt if dt > 0 else 0.0
        with self._lock:
            self._tok_rate_ema = (
                rate if self._tok_rate_ema == 0.0
                else 0.9 * self._tok_rate_ema + 0.1 * rate
            )
            ema = self._tok_rate_ema
        tel.gauge("serve.tokens_per_sec", ema)
        return True

    def _loop_body(self, tel, last_flush, wd) -> None:
        while not self._stop.is_set():
            wd.beat("serve.loop")
            # one pass of launches at a time among the engines sharing
            # this lock (Engine's host_lock); the idle wait is outside it
            with self.engine.host_lock:
                busy = self._pass(tel)
            if not busy:
                with self._wake:
                    if not self._queue and not self._stop.is_set():
                        self._wake.wait(timeout=IDLE_WAIT_S)

            with self._lock:
                tel.gauge("serve.queue_depth", len(self._queue))
            tel.gauge("serve.active_slots", self.engine.slots.active_count)
            if time.time() - last_flush > 1.0:
                self._retire_old(time.time())
                self._metrics_tick(time.time(), wd)
                tel.flush()
                last_flush = time.time()
        tel.flush()
