"""One serving replica: an engine+scheduler+RPC-server triple the router
owns.

The port's counterpart of :mod:`maggy_tpu.serve.fleet.replica`. A replica is
the fleet's unit of failure and of scale-out: each one runs the full
single-engine serving stack (:mod:`maggy_tpu_torch.serve`) on its own RPC
port, on a device lease carved the way the experiment drivers lease trial
cards (``core.driver.base.device_groups``: one group per replica,
round-robin when the host has fewer cards than replicas, so on one card
every replica serves on ``cuda:0``). Each replica listens on its own RPC
port as in JAX, but the router's private client calls the replica's verb
handlers in process (:class:`InProcessClient`): the port's decode step is
host-bound (thousands of launches a token), and a socket round trip per
poll, every 5 ms for every routed request, handed the GIL back and forth
between the router's pump, the replica's RPC thread and the decode loops.

**One copy of the weights per card.** The spec's parameters are cast to the
serving state (:func:`~maggy_tpu_torch.serve.engine.serving_state`: bf16
projections, fp32 norms and embedding) once per leased device
(:meth:`ReplicaSpec.serving_params`), and every replica on that device
builds its engine over the same tensors — the property JAX gets from
replicas sharing one set of ``params`` arrays. The replicas on one device
also share one host lock (:meth:`ReplicaSpec.host_lock`, the engines'
``host_lock``): their loops take turns at a pass of launches instead of
trading the interpreter lock at every one of a step's PyTorch ops.

Lifecycle: ``start()`` makes the lease's card current and builds the engine
there; ``stop(drain=True)`` finishes resident requests before closing;
``kill()`` drops everything on the floor — the chaos path
(``MAGGY_TPU_CHAOS="replica_kill:replica=N"``) — and lets go of the
replica's server, scheduler and engine, so the engine's KV pool is freed
when the scheduler thread ends, without the cyclic collector.
``respawn()`` rebuilds the whole stack after a kill, charged against the
router's restart budget. A ``mesh`` (a sharded replica) raises: ROADMAP
queue 1 item 7g.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from maggy_tpu_torch.core import lockdebug
from maggy_tpu_torch.exceptions import RpcError, RpcRejectedError
from maggy_tpu_torch.telemetry import tracing

# replica lifecycle states (the quarantine overlay lives in the router's
# QuarantineTracker, not here — a replica can be UP yet quarantined)
STARTING = "starting"
UP = "up"
DEAD = "dead"

# circuit-breaker states (docs/resilience.md "Gray failure & circuit
# breakers"): CLOSED dispatches normally; OPEN excludes the replica from
# dispatch; HALF_OPEN lets bounded probation probes through, whose observed
# TTFT closes the breaker or re-opens it
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-replica gray-failure breaker over latency-outlier scores.

    Health probes catch *dead* replicas; a gray replica answers every probe
    while serving tokens 10x slower than its peers. The router's metrics
    tick scores each replica's windowed TTFT p95 against the best healthy
    peer (:meth:`score`); consecutive outlier scores open the breaker,
    which removes the replica from dispatch without touching its liveness
    state. After ``cooldown_s`` the breaker half-opens: one probation probe
    at a time is dispatched, and the probe's observed TTFT
    (:meth:`observe_ttft`) either closes the breaker or re-opens it.

    Scored from the router's pump thread and read on dispatch; the lock
    keeps the state machine's compound transitions atomic.
    """

    def __init__(self, index: int, trips: int = 2, cooldown_s: float = 5.0):
        self.index = index
        self.trips = int(trips)
        self.cooldown_s = float(cooldown_s)
        self._lock = lockdebug.lock("replica.breaker")
        self._state = BREAKER_CLOSED  # guarded-by: _lock
        self._slow_streak = 0  # guarded-by: _lock
        self._opened_ts: Optional[float] = None  # guarded-by: _lock
        # TTFT a probation probe must beat to close (set when opening,
        # from the peer baseline that tripped us)  # guarded-by: _lock
        self._close_below_ms: float = 0.0
        self._probe_inflight = False  # guarded-by: _lock
        # rid of the probation dispatch: the verdict must come from the
        # probe itself, not an old slow stream polled during probation
        self._probe_rid: Optional[str] = None  # guarded-by: _lock
        self.opened_total = 0  # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def score(  # thread-entry — router pump's ~1 Hz metrics tick
        self,
        p95_ms: Optional[float],
        peer_p95_ms: Optional[float],
        ratio: float,
        min_ms: float,
        now: float,
    ) -> Optional[str]:
        """Feed one windowed latency score; returns ``"opened"`` on the
        CLOSED→OPEN transition, else None. A score is an outlier when this
        replica's TTFT p95 exceeds ``ratio`` x the best healthy peer's AND
        the absolute floor ``min_ms`` (so microsecond jitter between idle
        replicas never trips anything)."""
        slow = (
            p95_ms is not None
            and peer_p95_ms is not None
            and p95_ms >= min_ms
            and p95_ms > ratio * peer_p95_ms
        )
        with self._lock:
            if self._state != BREAKER_CLOSED:
                # open/half-open windows go stale (no fresh dispatches);
                # recovery is probe-driven, not score-driven
                return None
            self._slow_streak = self._slow_streak + 1 if slow else 0
            if self._slow_streak < self.trips:
                return None
            self._state = BREAKER_OPEN
            self._opened_ts = now
            self._slow_streak = 0
            self._probe_inflight = False
            self.opened_total += 1
            # a recovered replica should look like its peers did when we
            # tripped — with slack so marginal recovery still closes
            self._close_below_ms = max(min_ms, ratio * (peer_p95_ms or 0.0))
            return "opened"

    def ok(self, now: float) -> bool:  # thread-entry — router pump dispatch filter
        """May the router dispatch to this replica right now? Also drives
        the timed OPEN→HALF_OPEN transition."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN:
                if self._opened_ts is not None and (
                    now - self._opened_ts >= self.cooldown_s
                ):
                    self._state = BREAKER_HALF_OPEN
                    self._probe_inflight = False
                else:
                    return False
            # HALF_OPEN: one probation probe at a time
            return not self._probe_inflight

    def take_probe(self, rid: str) -> bool:
        """Claim the half-open probation slot for dispatch ``rid`` (the
        router calls this only after ``ok()``; CLOSED needs no claim)."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state != BREAKER_HALF_OPEN or self._probe_inflight:
                return False
            self._probe_inflight = True
            self._probe_rid = rid
            return True

    def observe_ttft(self, rid: str, ttft_ms: float, now: float) -> Optional[str]:  # thread-entry — router pump's poll loop
        """Feed an observed dispatch TTFT. Only the probation probe's own
        rid renders a HALF_OPEN verdict: fast closes the breaker, slow
        re-opens it (and restarts the cooldown). Returns ``"closed"`` /
        ``"reopened"`` on a transition, else None."""
        with self._lock:
            if self._state != BREAKER_HALF_OPEN or rid != self._probe_rid:
                return None
            self._probe_inflight = False
            self._probe_rid = None
            if ttft_ms <= self._close_below_ms:
                self._state = BREAKER_CLOSED
                self._opened_ts = None
                self._slow_streak = 0
                return "closed"
            self._state = BREAKER_OPEN
            self._opened_ts = now
            return "reopened"

    def probe_lost(self, rid: Optional[str] = None) -> None:
        """The probation dispatch died without a TTFT (replica went down,
        RPC failed): free the probe slot so probation can retry. With a
        rid, only that probe's claim is released."""
        with self._lock:
            if self._state != BREAKER_HALF_OPEN:
                return
            if rid is None or rid == self._probe_rid:
                self._probe_inflight = False
                self._probe_rid = None

    def reset(self) -> None:
        """Back to a pristine CLOSED breaker, for a respawned replica: the
        new engine shares nothing with the dead one, so a window built from
        pre-death latency samples would re-open a healthy replica on its
        predecessor's ghosts."""
        with self._lock:
            self._state = BREAKER_CLOSED
            self._slow_streak = 0
            self._opened_ts = None
            self._close_below_ms = 0.0
            self._probe_inflight = False
            self._probe_rid = None

    def begin_probation(self, close_below_ms: float) -> None:
        """Half-open-style admission gate for a freshly warmed replica
        (autoscaler scale-up): start in HALF_OPEN so the dispatch loop's
        probation-first path routes one canary request at a time, and an
        observed TTFT at or under ``close_below_ms`` closes the breaker —
        only then does the replica take weighted traffic. A slow canary
        re-opens it, exactly like gray-failure probation."""
        with self._lock:
            self._state = BREAKER_HALF_OPEN
            self._slow_streak = 0
            self._opened_ts = None
            self._close_below_ms = float(close_below_ms)
            self._probe_inflight = False
            self._probe_rid = None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "opened_total": self.opened_total,
                "close_below_ms": round(self._close_below_ms, 3),
            }


class RetryBudget:
    """Token bucket bounding how many requeues a replica's failures may
    inject back into the dispatch queue per window — a requeue storm from a
    flapping replica must not amplify an overload. When the bucket is dry
    the requeue still happens, but deferred (``RouteEntry.not_before_ts``),
    never dropped."""

    def __init__(self, capacity: int = 8, window_s: float = 10.0):
        self.capacity = max(1, int(capacity))
        self.window_s = float(window_s)
        self._lock = lockdebug.lock("replica.retry_budget")
        self._tokens = float(self.capacity)  # guarded-by: _lock
        self._last_ts: Optional[float] = None  # guarded-by: _lock

    def consume(self, now: float) -> bool:  # thread-entry — pump requeue paths
        """Take one token; False means the caller should defer its requeue."""
        with self._lock:
            if self._last_ts is not None:
                refill = (now - self._last_ts) * self.capacity / self.window_s
                self._tokens = min(float(self.capacity), self._tokens + refill)
            self._last_ts = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


@dataclasses.dataclass
class ReplicaSpec:
    """Everything needed to build (and rebuild) one replica's stack.

    ``params`` are the trained weights (a ``Decoder`` or its state_dict);
    ``device`` is where the fleet leases cards: None for every visible CUDA
    card (raises without CUDA), ``"cuda:N"`` for that card alone, ``"cpu"``
    for the CPU. ``serving`` caches the serving state per device and
    ``host_locks`` the engines' host lock per device; specs made from this
    one with ``dataclasses.replace`` share both."""

    cfg: Any
    params: Any
    num_slots: int = 4
    mesh: Any = None
    async_decode: Optional[bool] = None
    prefix_reuse: Optional[bool] = None
    # disaggregated prefill/decode: "any" replicas serve the classic full
    # stack; "prefill" replicas only run prompt prefills (the router wraps
    # them in PrefillWorker and never dispatches SUBMIT to them); "decode"
    # replicas admit handed-off KV packs (and still CAN prefill — the
    # fallback when every prefill replica is down)
    role: str = "any"
    # paged KV cache knobs threaded to each replica's engine (None: engine
    # defaults — paged on, DEFAULT_PAGE_SIZE)
    paged: Optional[bool] = None
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    # host-DRAM KV tier; None: engine default (on for paged engines,
    # MAGGY_TPU_SERVE_TIER gated)
    tier: Optional[bool] = None
    tier_host_pages: Optional[int] = None
    # TTFT budget handed to each replica's scheduler so per-replica SSTATS
    # carry exact slo_ok/slo_miss counters (launch_fleet seeds it from
    # RouterConfig.slo_ttft_ms)
    slo_ttft_ms: Optional[float] = None
    # index -> telemetry recorder, so each replica's gauges land in its own
    # worker JSONL
    telemetry_factory: Optional[Callable[[int], Any]] = None
    device: Any = None
    serving: Dict[torch.device, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    host_locks: Dict[torch.device, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a sharded replica (ReplicaSpec.mesh) belongs to the multi-device "
                "slice (ROADMAP queue 1 item 7g)"
            )

    def serving_params(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The serving state on ``device``, cast on first use and shared by
        every later caller (every replica on that device)."""
        state = self.serving.get(device)
        if state is None:
            from maggy_tpu_torch.serve.engine import serving_state

            state = serving_state(self.cfg, self.params, device)
            self.serving[device] = state
        return state

    def host_lock(self, device: torch.device):
        """The host lock every replica's engine on ``device`` holds around
        its passes of launches (``Engine(host_lock=)``)."""
        return self.host_locks.setdefault(device, threading.RLock())


class InProcessClient:
    """The router's private client of an in-process replica: the
    ``ServeServer``'s own verb handlers, called directly, behind
    ``ServeClient``'s surface and errors (a handler's exception is a
    rejection, :class:`RpcRejectedError`; a closed client is a dead port,
    :class:`RpcError`). No failover: fleet-level failover lives in the
    router, not in this hop."""

    def __init__(self, server):
        self._server = server

    HANDLERS = {"SUBMIT": "_on_submit", "POLL": "_on_poll", "CANCEL": "_on_cancel", "SSTATS": "_on_stats"}

    def _call(self, verb: str, msg: Dict[str, Any]) -> Dict[str, Any]:
        server = self._server
        if server is None:
            raise RpcError(f"{verb}: the replica's connection is closed")
        handler = getattr(server, self.HANDLERS[verb])
        try:
            with tracing.scope(msg.get("trace")):
                return handler({"type": verb, **msg})
        except Exception as e:  # noqa: BLE001 - the RPC server turns every handler error into a rejection
            raise RpcRejectedError(f"replica rejected message: {type(e).__name__}: {e}") from e

    def submit(self, prompt, **params) -> str:
        return self._call("SUBMIT", {"prompt": [int(t) for t in prompt], **params})["id"]

    def poll(self, request_id: str) -> Dict[str, Any]:
        return self._call("POLL", {"id": request_id})

    def cancel(self, request_id: str) -> bool:
        return bool(self._call("CANCEL", {"id": request_id}).get("cancelled"))

    def stats(self) -> Dict[str, Any]:
        return self._call("SSTATS", {})

    def close(self) -> None:
        self._server = None


def device_leases(device=None) -> List[List[torch.device]]:
    """The device groups replicas lease, one card each: every visible CUDA
    card (``device`` None or ``"cuda"``), the named card alone
    (``"cuda:N"``), or the CPU. Without CUDA and without a CPU device this
    raises: a replica never falls back to the CPU."""
    from maggy_tpu_torch.core.driver.base import device_groups

    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is not None:
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} requested but CUDA is not available")
            return [[device]]
    return device_groups(devices_per_trial=1, device=device)


class Replica:
    """In-process serving replica with a router-facing client."""

    def __init__(
        self,
        index: int,
        spec: ReplicaSpec,
        secret: str,
        host: str = "127.0.0.1",
        devices: Optional[list] = None,
    ):
        self.index = index
        self.spec = spec
        self.secret = secret
        self.host = host
        # the device lease this replica serves on: its engine is built on
        # devices[0]; without one, leases are carved round-robin by index
        if not devices:
            groups = device_leases(spec.device)
            devices = groups[index % len(groups)]
        self.devices = list(devices)
        self.device = self.devices[0]
        self.state = STARTING
        self.restarts = 0
        self.started_ts: Optional[float] = None
        self.addr: Optional[Tuple[str, int]] = None
        self.server = None  # ServeServer
        self.client = None  # router-owned ServeClient
        self._lock = lockdebug.lock("replica._lock")

    # -------------------------------------------------------------- lifecycle

    def _make_current(self) -> None:
        """CUDA's current device is per host thread: every thread that
        builds or drives this replica's engine makes its card current."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def start(self) -> Tuple[str, int]:
        from maggy_tpu_torch.serve import Engine, Scheduler, ServeServer

        spec = self.spec
        self._make_current()
        tel = (
            spec.telemetry_factory(self.index)
            if spec.telemetry_factory is not None
            else None
        )
        engine = Engine(
            spec.cfg,
            spec.serving_params(self.device),
            num_slots=spec.num_slots,
            telemetry_recorder=tel,
            async_decode=spec.async_decode,
            prefix_reuse=spec.prefix_reuse,
            paged=spec.paged,
            page_size=spec.page_size,
            num_pages=spec.num_pages,
            tier=spec.tier,
            tier_host_pages=spec.tier_host_pages,
            device=self.device,
            host_lock=spec.host_lock(self.device),
        )
        scheduler = Scheduler(engine, slo_ttft_ms=spec.slo_ttft_ms)
        # the replica_slow chaos seam keys on this index so one replica can
        # be made gray (slow-but-alive) while its peers stay fast
        scheduler.replica_index = self.index
        server = ServeServer(
            scheduler,
            secret=self.secret,
            name=f"replica-{self.index}",
        )
        addr = server.start(host=self.host, port=0)
        client = InProcessClient(server)
        with self._lock:
            # a kill() or stop() from another thread while this stack was
            # being built wins: the replica stays DEAD and the new stack goes
            killed = self.state == DEAD
            if not killed:
                self.server, self.client, self.addr = server, client, addr
                self.state = UP
        if killed:
            client.close()
            server.stop()
            server.scheduler = None
            raise RuntimeError(f"replica {self.index} was killed while it started")
        self.started_ts = time.time()
        return addr

    def alive(self) -> bool:
        with self._lock:
            return self.state == UP

    def _drop(self):
        """Let go of the client, server, scheduler and engine; returns the
        server for the caller's last calls on it."""
        with self._lock:
            server, client = self.server, self.client
            self.server = self.client = None
        if client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001 - socket may already be gone
                pass
        return server

    def kill(self) -> None:  # thread-entry — chaos/pump threads hard-kill replicas
        """Chaos/hard death: close the router's client and the port first
        (every in-flight and future router call fails the way a preempted
        host's would), then
        abandon the scheduler without draining. The replica's references to
        its server, scheduler and engine go with it; once the scheduler
        thread ends nothing holds the engine, so its KV pool is freed."""
        with self._lock:
            if self.state == DEAD:
                return
            self.state = DEAD
        server = self._drop()
        if server is not None:
            self._make_current()
            server._rpc.stop()
            server.scheduler.stop(timeout=2.0)
            # the server and its RPC callbacks form a reference cycle: cut
            # the scheduler (and its engine) out of it
            server.scheduler = None

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Clean shutdown: finish resident work before closing sockets."""
        with self._lock:
            if self.state == DEAD:
                return
            self.state = DEAD
            server = self.server
        if server is not None and drain:
            server.scheduler.drain(timeout=timeout)
        server = self._drop()
        if server is not None:
            server.stop()
            server.scheduler = None

    def respawn(self) -> Tuple[str, int]:
        """Rebuild the full stack after a death (new engine, new port).
        Counts one restart; the router enforces the budget."""
        self.restarts += 1
        with self._lock:
            self.state = STARTING
        return self.start()

    # ------------------------------------------------------------------ stats

    def local_stats(self) -> Optional[Dict[str, Any]]:
        """Freshest scheduler stats for an in-process replica — lock-guarded
        host state only, no sockets, so the router's SSTATS handler may call
        it on the event loop. None when the replica is down."""
        with self._lock:
            if self.state != UP or self.server is None:
                return None
            server = self.server
        try:
            return server.scheduler.stats()
        except Exception:  # noqa: BLE001 - racing a concurrent kill()
            return None

    def submit_prefilled(self, payload: Dict[str, Any], pack: Dict[str, Any]) -> str:
        """Disaggregated handoff (in-process seam): enqueue a request whose
        KV pack a prefill replica produced. Returns the downstream request
        id, exactly like ``client.submit`` — POLL/CANCEL work unchanged.
        Raises for a dead replica; the router falls back to a plain submit
        (the decode engine prefills for itself)."""
        with self._lock:
            if self.state != UP or self.server is None:
                raise RuntimeError(f"replica {self.index} cannot accept a handoff")
            server = self.server
        from maggy_tpu_torch.serve.request import SamplingParams

        params = SamplingParams(
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            max_new=int(payload.get("max_new", 16)),
            eos_id=int(payload.get("eos_id", -1)),
            seed=int(payload.get("seed", 0)),
        )
        deadline_s = payload.get("deadline_s")
        req = server.scheduler.submit_prefilled(
            payload["prompt"],
            params,
            pack,
            deadline_s=float(deadline_s) if deadline_s else None,
            trace=payload.get("trace"),
            tenant=payload.get("tenant"),
            qos=payload.get("qos"),
        )
        return req.id

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            state = self.state
        return {
            "replica": self.index,
            "role": self.spec.role,
            "state": state,
            "addr": f"{self.addr[0]}:{self.addr[1]}" if self.addr else None,
            "restarts": self.restarts,
            "devices": [str(d) for d in self.devices],
            "uptime_s": (
                round(time.time() - self.started_ts, 1)
                if self.started_ts and state == UP
                else None
            ),
        }


def build_replicas(
    spec: ReplicaSpec, n: int, secret: str, host: str = "127.0.0.1"
) -> list:
    """N replicas over this host's card leases (one group per replica,
    round-robin when the host has fewer cards than replicas). The serving
    state is cast here, once per distinct leased device, and shared by
    every replica on it."""
    groups = device_leases(spec.device)
    leases = [groups[i % len(groups)] for i in range(n)]
    for device in dict.fromkeys(lease[0] for lease in leases):
        spec.serving_params(device)
    return [
        Replica(i, spec, secret, host=host, devices=leases[i]) for i in range(n)
    ]
