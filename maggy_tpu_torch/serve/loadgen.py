"""Deterministic traffic replay for overload and QoS testing.

A copy of :mod:`maggy_tpu.serve.loadgen`.

Overload behaviour (brownout ladders, quota starvation, priority
preemption) can't be tested with hand-rolled submit loops — the interesting
failures live in the *shape* of traffic: diurnal load swell, correlated
bursts, tenants with shared-prefix prompt populations, a mixed-class
request population. This module makes that shape a seeded value:

* :func:`generate` turns a :class:`TrafficSpec` into a flat, time-sorted
  schedule of :class:`Arrival` rows. Same spec + same seed = the same
  schedule, byte for byte, on any machine — so an overload acceptance test
  replays the *identical* storm every run, and a bench compares two builds
  under the *identical* offered load.
* :class:`TrafficReplay` paces a schedule against a live
  :class:`~maggy_tpu_torch.serve.client.ServeClient` (engine or fleet router —
  same verb set) from a background thread, collecting per-request outcomes
  (tokens, TTFT, shed/expired/failed) for the caller to assert on.

Arrival times are a per-tenant inhomogeneous Poisson process: each tenant's
rate is ``base_rps x weight-fraction x diurnal(t) x burst(t)``, thinned
into exponential inter-arrival gaps by a tenant-private
``random.Random(seed)`` stream, so adding a tenant (or reordering the mix)
never perturbs another tenant's arrivals. The chaos seam ``tenant_burst``
(:mod:`maggy_tpu_torch.resilience.chaos`) multiplies one tenant's offered load at
schedule-build time, so a flood scenario is spelled as chaos
(``tenant_burst:tenant=bulk,mult=5``) instead of a bespoke spec.

Prompts come from a shared-prefix population: each tenant owns
``n_prefixes`` seeded prefix stems and every prompt is ``stem + fresh
suffix`` — the distribution that makes prefix caches and paged-KV sharing
do real work (docs/serving.md).
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from maggy_tpu_torch.core import lockdebug
from maggy_tpu_torch.exceptions import RpcError, ServerBusyError
from maggy_tpu_torch.resilience import chaos as chaos_mod
from maggy_tpu_torch.serve.qos import DEFAULT_QOS, validate_qos


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """One tenant's slice of the offered load."""

    tenant: str
    qos: str = DEFAULT_QOS
    weight: float = 1.0  # share of base_rps, normalized over all tenants
    prompt_len: int = 12  # tokens per prompt (stem + suffix)
    prefix_len: int = 0  # leading tokens drawn from a shared stem pool
    n_prefixes: int = 4  # size of this tenant's stem pool
    max_new: int = 8


@dataclasses.dataclass(frozen=True)
class Burst:
    """A correlated load spike: multiply every tenant's rate by ``mult``
    inside [start_s, start_s + duration_s)."""

    start_s: float
    duration_s: float
    mult: float = 4.0


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """A complete, seeded description of an offered-load scenario."""

    seed: int
    duration_s: float
    base_rps: float
    tenants: Tuple[TenantMix, ...]
    # diurnal curve: rate(t) *= 1 + amp * sin(2*pi*t / period_s); amp=0
    # is flat. period defaults to the duration (one full swell per run).
    diurnal_amp: float = 0.0
    diurnal_period_s: Optional[float] = None
    bursts: Tuple[Burst, ...] = ()
    vocab: int = 256  # token ids are drawn from [2, vocab)

    def validate(self) -> None:
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if self.base_rps <= 0:
            raise ValueError(f"base_rps must be > 0, got {self.base_rps}")
        if not self.tenants:
            raise ValueError("spec needs at least one TenantMix")
        for t in self.tenants:
            validate_qos(t.qos)
            if t.weight <= 0:
                raise ValueError(f"tenant {t.tenant!r}: weight must be > 0")
            if t.prefix_len > t.prompt_len:
                raise ValueError(
                    f"tenant {t.tenant!r}: prefix_len {t.prefix_len} exceeds "
                    f"prompt_len {t.prompt_len}"
                )


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit ``prompt`` at ``at_s`` (relative to
    replay start) for ``tenant`` under ``qos``."""

    at_s: float
    tenant: str
    qos: str
    prompt: Tuple[int, ...]
    max_new: int
    seq: int  # global arrival index after the time-sort (stable tiebreak)


def diurnal_burst_spec(
    *,
    seed: int = 7,
    duration_s: float = 12.0,
    base_rps: float = 6.0,
    burst_mult: float = 4.0,
    diurnal_amp: float = 0.6,
    max_new: int = 6,
) -> TrafficSpec:
    """The canned capacity-planning scenario: a diurnal swell with a
    correlated burst pinned to the swell's crest.

    This is the offered load the fleet autoscaler is sized against
    (``bench.py extra.autoscale``, ``tests/test_autoscale.py``): quiet
    shoulders where scale-in should engage, a crest that demands
    scale-out, and a mid-crest burst that drives the brownout ladder to
    level >= 2. Two tenants (a standard-class majority with shared prefix
    stems and a best-effort bulk minority) keep the QoS machinery honest
    during scale events. Same arguments = the same schedule, byte for
    byte (docs/fleet.md, "Autoscaling").
    """
    return TrafficSpec(
        seed=seed,
        duration_s=duration_s,
        base_rps=base_rps,
        tenants=(
            TenantMix(
                tenant="web",
                qos="standard",
                weight=3.0,
                prompt_len=12,
                prefix_len=6,
                n_prefixes=4,
                max_new=max_new,
            ),
            TenantMix(
                tenant="bulk",
                qos="best_effort",
                weight=1.0,
                prompt_len=10,
                max_new=max_new,
            ),
        ),
        diurnal_amp=diurnal_amp,
        # one full swell per run; the burst sits on the crest (t = T/4)
        diurnal_period_s=duration_s,
        bursts=(
            Burst(
                start_s=duration_s / 4,
                duration_s=duration_s / 6,
                mult=burst_mult,
            ),
        ),
    )


def _rate_at(spec: TrafficSpec, t: float, mix: TenantMix, frac: float) -> float:
    """This tenant's instantaneous requests/sec at offset ``t``."""
    rate = spec.base_rps * frac
    if spec.diurnal_amp:
        period = spec.diurnal_period_s or spec.duration_s
        rate *= max(0.0, 1.0 + spec.diurnal_amp * math.sin(2 * math.pi * t / period))
    for b in spec.bursts:
        if b.start_s <= t < b.start_s + b.duration_s:
            rate *= b.mult
    return rate


def generate(spec: TrafficSpec) -> List[Arrival]:
    """Expand a spec into its deterministic, time-sorted arrival schedule.

    Each tenant gets a private PRNG stream keyed off ``spec.seed`` and its
    index in the mix, and the inhomogeneous Poisson process is realized by
    thinning: candidate gaps are drawn at the tenant's *peak* rate, then
    accepted with probability rate(t)/peak — exact, and deterministic for a
    fixed spec. The chaos ``tenant_burst`` seam is consulted once per
    tenant at build time (schedule construction is the seam's documented
    consumer, so replays under chaos are still fully deterministic).
    """
    spec.validate()
    total_weight = sum(t.weight for t in spec.tenants)
    ch = chaos_mod.get()
    arrivals: List[Arrival] = []
    for idx, mix in enumerate(spec.tenants):
        rng = random.Random(spec.seed * 1000003 + idx)
        frac = mix.weight / total_weight
        burst_mult = ch.tenant_burst(mix.tenant) if ch is not None else 1.0
        # peak rate bounds the thinning proposal density
        peak = max(
            _rate_at(spec, t, mix, frac)
            for t in (
                0.0,
                spec.duration_s / 4,
                spec.duration_s / 2,
                3 * spec.duration_s / 4,
            )
        )
        for b in spec.bursts:
            peak = max(peak, _rate_at(spec, b.start_s, mix, frac))
        peak *= burst_mult
        if peak <= 0:
            continue
        stems = [
            tuple(rng.randrange(2, spec.vocab) for _ in range(mix.prefix_len))
            for _ in range(max(1, mix.n_prefixes))
        ]
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= spec.duration_s:
                break
            accept = _rate_at(spec, t, mix, frac) * burst_mult / peak
            if rng.random() > accept:
                continue
            stem = stems[rng.randrange(len(stems))] if mix.prefix_len else ()
            suffix = tuple(
                rng.randrange(2, spec.vocab)
                for _ in range(mix.prompt_len - mix.prefix_len)
            )
            arrivals.append(
                Arrival(
                    at_s=t,
                    tenant=mix.tenant,
                    qos=mix.qos,
                    prompt=stem + suffix,
                    max_new=mix.max_new,
                    seq=0,  # assigned after the global sort
                )
            )
    arrivals.sort(key=lambda a: (a.at_s, a.tenant))
    return [dataclasses.replace(a, seq=i) for i, a in enumerate(arrivals)]


class TrafficReplay:
    """Pace a schedule against a live serving endpoint.

    ``start()`` launches a pacing thread that submits each arrival at its
    scheduled offset (never early; late only when the endpoint itself is
    slow — which is the overload signal under test, not a harness bug) and
    a polling pass that resolves submitted requests to terminal snapshots.
    Outcomes accumulate under the lock; ``wait()`` joins and returns them.

    One outcome dict per arrival: ``{seq, tenant, qos, status, rid?,
    snapshot?, error?, submitted_at_s}`` where status is ``done`` /
    ``cancelled`` / ``expired`` / ``failed`` / ``shed`` (typed BUSY) /
    ``submit_error`` / ``timeout``.
    """

    def __init__(
        self,
        client: Any,
        schedule: Sequence[Arrival],
        *,
        retry_busy: int = 0,
        result_timeout_s: float = 60.0,
        speed: float = 1.0,
        on_submit: Optional[Callable[[Arrival, Optional[str]], None]] = None,
    ):
        self.client = client
        self.schedule = list(schedule)
        self.retry_busy = int(retry_busy)
        self.result_timeout_s = float(result_timeout_s)
        self.speed = float(speed)  # >1 compresses the timeline (tests)
        self.on_submit = on_submit
        self._lock = lockdebug.lock("serve.loadgen")
        self.outcomes: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._inflight: List[Tuple[Arrival, str, float]] = []  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._started_ts: Optional[float] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "TrafficReplay":
        if self._thread is not None:
            raise RuntimeError("replay already started")
        self._started_ts = time.time()
        self._thread = threading.Thread(
            target=self._pace_loop, name="traffic-replay", daemon=True
        )
        self._thread.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> List[Dict[str, Any]]:
        """Join the pacing thread and return all outcomes (time-ordered by
        arrival seq)."""
        if self._thread is None:
            raise RuntimeError("replay not started")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RpcError("traffic replay did not finish in time")
        with self._lock:
            return sorted(self.outcomes, key=lambda o: o["seq"])

    def run(self, timeout: Optional[float] = None) -> List[Dict[str, Any]]:
        return self.start().wait(timeout)

    # --------------------------------------------------------------- pacing

    def _record(self, outcome: Dict[str, Any]) -> None:
        with self._lock:
            self.outcomes.append(outcome)

    def _pace_loop(self) -> None:  # thread-entry — paces the schedule in real time
        start = self._started_ts or time.time()
        for arrival in self.schedule:
            due = start + arrival.at_s / self.speed
            delay = due - time.time()
            if delay > 0:
                time.sleep(delay)
            self._drain_done(block=False)
            self._submit_one(arrival)
        # schedule exhausted: resolve everything still in flight
        self._drain_done(block=True)

    def _submit_one(self, arrival: Arrival) -> None:
        submitted_at = time.time() - (self._started_ts or 0.0)
        base = {
            "seq": arrival.seq,
            "tenant": arrival.tenant,
            "qos": arrival.qos,
            "submitted_at_s": round(submitted_at, 4),
        }
        try:
            rid = self.client.submit(
                list(arrival.prompt),
                max_new=arrival.max_new,
                tenant=arrival.tenant,
                qos=arrival.qos,
                retry_busy=self.retry_busy,
            )
        except ServerBusyError as e:
            self._record({**base, "status": "shed", "error": str(e)})
            if self.on_submit is not None:
                self.on_submit(arrival, None)
            return
        except (RpcError, OSError, ValueError) as e:
            self._record({**base, "status": "submit_error", "error": str(e)})
            if self.on_submit is not None:
                self.on_submit(arrival, None)
            return
        with self._lock:
            self._inflight.append((arrival, rid, time.time()))
        if self.on_submit is not None:
            self.on_submit(arrival, rid)

    def _drain_done(self, block: bool) -> None:
        """Resolve in-flight requests to terminal outcomes; when ``block``
        poll until all are terminal or individually timed out."""
        while True:
            with self._lock:
                inflight = list(self._inflight)
            if not inflight:
                return
            still: List[Tuple[Arrival, str, float]] = []
            for arrival, rid, t0 in inflight:
                base = {
                    "seq": arrival.seq,
                    "tenant": arrival.tenant,
                    "qos": arrival.qos,
                    "submitted_at_s": round(
                        t0 - (self._started_ts or 0.0), 4
                    ),
                    "rid": rid,
                }
                try:
                    snap = self.client.poll(rid)
                except (RpcError, OSError) as e:
                    self._record({**base, "status": "failed", "error": str(e)})
                    continue
                if snap.get("done"):
                    self._record(
                        {**base, "status": snap.get("state"), "snapshot": snap}
                    )
                elif time.time() - t0 > self.result_timeout_s:
                    self._record(
                        {**base, "status": "timeout", "snapshot": snap}
                    )
                else:
                    still.append((arrival, rid, t0))
            with self._lock:
                self._inflight = still
            if not block or not still:
                return
            time.sleep(0.02)


def summarize(outcomes: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-class rollup of a replay's outcomes: counts by status, TTFT
    percentiles of completed requests, shed fraction — the shape the
    overload acceptance test and ``bench.py extra.qos`` both assert on."""
    by_class: Dict[str, Dict[str, Any]] = {}
    for o in outcomes:
        cls = by_class.setdefault(
            o["qos"], {"n": 0, "status": {}, "ttft_ms": []}
        )
        cls["n"] += 1
        cls["status"][o["status"]] = cls["status"].get(o["status"], 0) + 1
        snap = o.get("snapshot") or {}
        if o["status"] == "done" and snap.get("ttft_ms") is not None:
            cls["ttft_ms"].append(float(snap["ttft_ms"]))
    out: Dict[str, Any] = {}
    for qos, cls in by_class.items():
        ttfts = sorted(cls["ttft_ms"])

        def pct(q: float) -> Optional[float]:
            if not ttfts:
                return None
            return ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]

        out[qos] = {
            "n": cls["n"],
            "status": dict(cls["status"]),
            "done": cls["status"].get("done", 0),
            "shed": cls["status"].get("shed", 0),
            "ttft_p50_ms": pct(0.50),
            "ttft_p95_ms": pct(0.95),
        }
    return out
