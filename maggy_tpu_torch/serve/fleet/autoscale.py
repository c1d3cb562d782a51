"""Fleet autoscaler: close the capacity loop with drain-safe scale events.

The port's counterpart of :mod:`maggy_tpu.serve.fleet.autoscale`, the same
decision ladder and phase machine. A spawned replica takes its card lease
round-robin by fleet index and the spec's shared serving weights; the warm
thread builds it on that card (``Replica.start`` makes the card current in
the calling thread).

The robustness stack below this module reacts on two timescales already:
the brownout ladder degrades best-effort traffic within *seconds* of an SLO
burn (docs/fleet.md "QoS classes & graceful degradation"), and circuit
breakers sideline a gray replica within a couple of metric ticks
(docs/resilience.md "Gray failure & circuit breakers"). What the fleet
could not do was change its own *size*: sustained overload beyond what
brownout can shed was terminal, and sustained idle burned replica-hours.
The :class:`Autoscaler` closes that loop on the *minutes* timescale, from
the same fleet time-series the router already keeps.

Decision inputs (sampled each tick from the router, no new telemetry):

* brownout ladder level — sustained level >= ``escalate_level`` means the
  seconds-scale response is saturated: escalate to scale-out;
* fleet slot utilization (active/total over dispatchable decode replicas)
  against the ``target_util`` knob;
* router queue depth and the minimum replica HBM headroom;
* exact fleet-edge SLO counters (``Router.slo_ok``/``slo_miss``) for the
  post-scale regression guard.

The handoff with the brownout ladder is explicit and hysteretic so the two
controllers never fight: brownout acts in seconds and is the *first*
responder; the autoscaler only escalates after brownout has been pinned at
level >= 2 for ``escalate_hold_s`` (the ladder clearly cannot shed its way
out), and it only scales IN at brownout level 0 with enough slot headroom
that the survivors absorb the victim's load below ``target_util``. Every
decision is separated by ``scale_cooldown_s`` so a burst's edge cannot flap
the fleet.

Scale events are safe by construction:

* **Scale-up** spawns the replica off the pump thread, warms it (engine
  build + compile + one end-to-end probe request), and only then admits it
  to the router behind a half-open-style probation gate
  (:meth:`CircuitBreaker.begin_probation`): the router's dispatch loop
  routes one canary request at a time until an observed TTFT under the SLO
  closes the breaker — a replica that compiles but serves slowly never
  takes weighted traffic.
* **Scale-down** drains the victim: dispatch stops first
  (``Router.begin_drain``), in-flight waves get ``drain_grace_s`` to
  finish, then remaining streams are cancelled downstream — the victim's
  page release spills reusable prefix KV through the host tier seam
  (docs/serving.md "Host-DRAM page tier") — and requeued to survivors, the
  victim's FleetPrefixMap entries and SeriesStore are forgotten, and the
  replica retires. Completions are byte-identical either way because engine
  output is a pure function of (params, prompt, seed). A chaos
  ``replica_kill_mid_drain`` fault mid-drain falls back to the router's
  plain requeue-on-death path — same guarantee, exercised in tests.
* Every decision mirrors the autopilot's baseline→trial→commit-or-rollback
  shape (docs/autotune.md "Rollback semantics"): the pre-event SLO
  attainment is the baseline, the post-event ``guard_window_s`` is the
  trial, and a regression beyond ``regress_tol`` auto-reverts the event
  (scale-in regressed → respawn; scale-up regressed → drain it back out).
  Decisions are journaled as ``fleet.scale.*`` events.

In a disaggregated fleet the prefill:decode role mix scales too: the mix
fraction observed at attach time is the target, scale-out spawns whichever
role is under-represented and scale-in retires from the over-represented
pool, so growing the fleet never starves one side of the handoff.

Ticked by the router's pump thread; the lock guards the phase machine
(pinned in ``tools/check_concurrency.py`` REQUIRED_MODELS). See
docs/fleet.md "Autoscaling".
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from maggy_tpu_torch.core import lockdebug
from maggy_tpu_torch.resilience import chaos as chaos_mod
from maggy_tpu_torch.serve.fleet.replica import DEAD, UP, Replica

# phase machine states (one scale event in flight at a time, ever)
STEADY = "steady"
WARMING = "warming"
DRAINING = "draining"
GUARD = "guard"


@dataclasses.dataclass
class AutoscaleConfig:
    """Capacity-loop knobs (docs/fleet.md "Autoscaling"). The first four
    are autopilot-registered (``fleet.min_replicas`` / ``fleet.max_replicas``
    / ``fleet.scale_cooldown_s`` / ``fleet.target_util``)."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_cooldown_s: float = 20.0  # minimum gap between scale events
    target_util: float = 0.80  # fleet slot utilization ceiling
    low_util: float = 0.30  # scale-in candidate floor
    # brownout handoff: the ladder must be pinned at >= escalate_level for
    # escalate_hold_s before the autoscaler treats shedding as saturated
    escalate_level: int = 2
    escalate_hold_s: float = 4.0
    high_hold_s: float = 3.0  # util > target must persist this long
    low_hold_s: float = 6.0  # idle must persist this long
    min_headroom_pct: float = 0.05  # scale-in blocked under HBM pressure
    # post-scale regression guard (the autopilot trial-window shape)
    guard_window_s: float = 8.0
    regress_tol: float = 0.10
    # scale-up warm path: compile + end-to-end probe before admission
    warm_timeout_s: float = 120.0
    probe_prompt: Tuple[int, ...] = (2, 3, 4, 5)
    # scale-down drain path: waves get the grace, then streams are
    # cancelled downstream (spilling prefix KV through the tier seam) and
    # requeued; the timeout hard-kills a wedged drain (requeue fallback)
    drain_grace_s: float = 5.0
    drain_timeout_s: float = 30.0

    def validate(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}"
            )
        if not 0.0 < self.target_util <= 1.0:
            raise ValueError(f"target_util must be in (0, 1], got {self.target_util}")
        if self.low_util >= self.target_util:
            raise ValueError(
                f"low_util {self.low_util} must be below target_util "
                f"{self.target_util} (hysteresis band)"
            )


@dataclasses.dataclass(frozen=True)
class Observation:
    """One tick's decision inputs, separated from actuation so the
    escalation/de-escalation ladder is unit-testable without a fleet."""

    now: float
    replicas: int  # decode-capable, non-draining (the scalable pool)
    util: Optional[float]  # active/total slots over that pool
    queue_depth: int
    brownout_level: int
    headroom_pct: Optional[float]  # minimum over replicas; None = unknown


class Autoscaler:
    """Grow/shrink the fleet from its own time-series, drain-safely.

    Owned by the router (``Router(..., autoscale=...)``) and ticked from
    its pump thread after each metrics tick; the warm worker is the only
    other thread, and it touches nothing but its replica and the
    lock-guarded warm slot.
    """

    def __init__(
        self,
        router,
        config: Optional[AutoscaleConfig] = None,
        spec=None,
        host: Optional[str] = None,
    ):
        self.router = router
        self.config = config or AutoscaleConfig()
        self.config.validate()
        self._lock = lockdebug.lock("fleet.autoscale")
        self._phase = STEADY  # guarded-by: _lock
        # decision-episode hysteresis clocks  # guarded-by: _lock
        self._esc_since: Optional[float] = None
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._last_event_ts: Optional[float] = None  # guarded-by: _lock
        self._at_capacity = False  # guarded-by: _lock
        self._capacity_logged = False  # guarded-by: _lock
        # one in-flight scale event, ever  # guarded-by: _lock
        self._warm: Optional[Dict[str, Any]] = None
        self._drain: Optional[Dict[str, Any]] = None
        self._guard: Optional[Dict[str, Any]] = None
        # journal mirror (the telemetry events are the durable record;
        # this ring is the STATUS/test surface)  # guarded-by: _lock
        self.events: deque = deque(maxlen=64)
        # fleet-edge SLO counter ring for the regression guard
        self._slo_ring: deque = deque(maxlen=512)  # guarded-by: _lock
        # spawn templates: the decode spec (and host) new replicas clone
        template = None
        for r in router.replicas:
            if getattr(r.spec, "role", "any") != "prefill":
                template = r
                break
        self._template_spec = spec if spec is not None else (
            template.spec if template is not None else None
        )
        self._host = host or (template.host if template is not None else "127.0.0.1")
        # disaggregated role mix: the attach-time prefill fraction is the
        # target the scaler preserves while growing/shrinking
        n_prefill = sum(
            1 for r in router.replicas
            if getattr(r.spec, "role", "any") == "prefill"
        )
        n_total = len(router.replicas)
        self._target_prefill_frac = n_prefill / n_total if n_total else 0.0

    # ---------------------------------------------------------------- inputs

    def observe(self, now: float) -> Observation:
        """Sample the decision inputs from router state (pump thread)."""
        router = self.router
        with router._lock:
            pool = [
                r
                for r in router.replicas
                if getattr(r.spec, "role", "any") != "prefill"
                and r.index not in router._draining
                and r.state != DEAD
            ]
            active = total = 0
            headroom: Optional[float] = None
            for r in pool:
                stats = router._stats_cache.get(r.index) or {}
                active += int(stats.get("active_slots") or 0)
                total += int(stats.get("num_slots", r.spec.num_slots) or 0)
                hp = (stats.get("memory") or {}).get("headroom_pct")
                if hp is not None:
                    headroom = (
                        float(hp) if headroom is None else min(headroom, float(hp))
                    )
            queue_depth = len(router._pending)
        return Observation(
            now=now,
            replicas=len(pool),
            util=(active / total) if total else None,
            queue_depth=queue_depth,
            brownout_level=router.brownout.level(),
            headroom_pct=headroom,
        )

    def _record_slo(self, now: float) -> None:
        router = self.router
        if router.config.slo_ttft_ms is None:
            return
        with router._lock:
            ok, miss = router.slo_ok, router.slo_miss
        with self._lock:
            self._slo_ring.append((now, ok, miss))

    def _attainment(self, now: float, window_s: float) -> Optional[float]:
        """Fleet-edge SLO attainment over the trailing window (None until
        a request has been judged inside it)."""
        with self._lock:
            ring = list(self._slo_ring)
        if not ring:
            return None
        base = ring[0]
        for sample in ring:
            if sample[0] <= now - window_s:
                base = sample
            else:
                break
        _, ok0, miss0 = base
        _, ok1, miss1 = ring[-1]
        judged = (ok1 - ok0) + (miss1 - miss0)
        if judged <= 0:
            return None
        return (ok1 - ok0) / judged

    # -------------------------------------------------------------- decisions

    def decide(self, obs: Observation) -> Optional[str]:
        """Pure escalation/de-escalation ladder over one observation:
        returns ``"up"``, ``"down"``, or None. Hysteresis clocks live on
        the instance; cooldown and min/max clamps are applied here so the
        flap-prevention rules are what the unit tests exercise.

        Escalation: brownout pinned at >= ``escalate_level`` for
        ``escalate_hold_s`` (the seconds-scale response is saturated), or
        utilization over ``target_util`` for ``high_hold_s``.
        De-escalation: brownout 0 AND idle (util < ``low_util``, empty
        queue) for ``low_hold_s`` AND enough headroom that the survivors
        absorb the victim's load under ``target_util``."""
        cfg = self.config
        now = obs.now
        with self._lock:
            # ---- escalation pressure clocks
            if obs.brownout_level >= cfg.escalate_level:
                if self._esc_since is None:
                    self._esc_since = now
            else:
                self._esc_since = None
            if obs.util is not None and obs.util > cfg.target_util:
                if self._high_since is None:
                    self._high_since = now
            else:
                self._high_since = None
            want_up = (
                self._esc_since is not None
                and now - self._esc_since >= cfg.escalate_hold_s
            ) or (
                self._high_since is not None
                and now - self._high_since >= cfg.high_hold_s
            )
            # ---- de-escalation clock: only at brownout 0, only when idle
            idle = (
                obs.brownout_level == 0
                and not want_up
                and obs.queue_depth == 0
                and obs.util is not None
                and obs.util < cfg.low_util
            )
            if idle:
                if self._low_since is None:
                    self._low_since = now
            else:
                self._low_since = None
            want_down = (
                self._low_since is not None
                and now - self._low_since >= cfg.low_hold_s
            )
            # ---- clamps + flap prevention
            cooling = (
                self._last_event_ts is not None
                and now - self._last_event_ts < cfg.scale_cooldown_s
            )
            self._at_capacity = bool(want_up and obs.replicas >= cfg.max_replicas)
            if want_up:
                if obs.replicas >= cfg.max_replicas:
                    if not self._capacity_logged:
                        self._capacity_logged = True
                        self._journal_locked(
                            "fleet.scale.blocked", now,
                            reason="at_max_replicas", replicas=obs.replicas,
                        )
                    return None
                if cooling:
                    return None
                return "up"
            self._capacity_logged = False
            if want_down:
                if obs.replicas <= cfg.min_replicas or cooling:
                    return None
                # survivors must absorb the victim's load under target —
                # and HBM headroom must not already be tight
                if obs.util is not None and obs.replicas > 1:
                    projected = obs.util * obs.replicas / (obs.replicas - 1)
                    if projected > cfg.target_util:
                        return None
                if (
                    obs.headroom_pct is not None
                    and obs.headroom_pct < cfg.min_headroom_pct
                ):
                    return None
                return "down"
            return None

    def at_capacity(self) -> bool:
        """Scale-out pressure exists but the fleet is at ``max_replicas``
        (the ``fleet.at_capacity`` gauge / ``alert.fleet_at_capacity``)."""
        with self._lock:
            return self._at_capacity

    # ----------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> None:  # thread-entry — router pump, after each metrics tick
        now = time.time() if now is None else now
        self._record_slo(now)
        with self._lock:
            phase = self._phase
        if phase == STEADY:
            action = self.decide(self.observe(now))
            if action == "up":
                self._begin_scale_up(now, reason=self._pressure_reason(now))
            elif action == "down":
                self._begin_scale_down(now, reason="idle")
        elif phase == WARMING:
            self._tick_warming(now)
        elif phase == DRAINING:
            self._tick_draining(now)
        elif phase == GUARD:
            self._tick_guard(now)

    def _pressure_reason(self, now: float) -> str:
        with self._lock:
            if (
                self._esc_since is not None
                and now - self._esc_since >= self.config.escalate_hold_s
            ):
                return "brownout"
            return "util"

    # ------------------------------------------------------------- journaling

    def _journal_locked(self, event: str, now: float, **attrs: Any) -> None:
        self.events.append({"event": event, "ts": round(now, 3), **attrs})
        self.router.telemetry.event(event, **attrs)

    def _journal(self, event: str, now: float, **attrs: Any) -> None:
        with self._lock:
            self._journal_locked(event, now, **attrs)

    # --------------------------------------------------------------- scale-up

    def _spawn_role(self) -> str:
        """The role whose pool is under its attach-time mix fraction —
        the rule that grows a disaggregated fleet without starving either
        side of the prefill→decode handoff."""
        if self._target_prefill_frac <= 0:
            return getattr(self._template_spec, "role", "any")
        router = self.router
        with router._lock:
            n_prefill = sum(
                1 for r in router.replicas
                if getattr(r.spec, "role", "any") == "prefill" and r.state != DEAD
            )
            n_total = sum(1 for r in router.replicas if r.state != DEAD)
        frac_if_decode = n_prefill / (n_total + 1)
        return "prefill" if frac_if_decode < self._target_prefill_frac else "decode"

    def _begin_scale_up(self, now: float, reason: str, revert: bool = False) -> None:
        if self._template_spec is None:
            return
        router = self.router
        role = self._spawn_role()
        spec = self._template_spec
        if getattr(spec, "role", "any") != role:
            spec = dataclasses.replace(spec, role=role)
        index = router.allocate_index()
        replica = Replica(index, spec, router.secret, host=self._host)
        baseline = None if revert else self._attainment(now, self.config.guard_window_s)
        with self._lock:
            self._phase = WARMING
            self._last_event_ts = now
            self._warm = {
                "replica": replica,
                "started": now,
                "done": False,
                "error": None,
                "revert": revert,
                "baseline": baseline,
                "reason": reason,
            }
            self._journal_locked(
                "fleet.scale.up", now, replica=index, role=role,
                reason=reason, revert=revert,
            )
        router.telemetry.count("fleet.scale_events")
        router.log(
            f"autoscale: scale-out -> replica {index} ({role}, {reason})"
        )
        threading.Thread(
            target=self._warm_worker,
            args=(replica,),
            name=f"maggy-warm-{index}",
            daemon=True,
        ).start()

    def _warm_worker(self, replica: Replica) -> None:  # thread-entry — warms one spawned replica off the pump
        """Engine build + compile + one end-to-end probe; the chaos
        ``replica_spawn_slow`` seam injects warm-up latency here."""
        ch = chaos_mod.get()
        if ch is not None:
            delay = ch.replica_spawn_slow(replica.index)
            if delay > 0:
                time.sleep(delay)
        error: Optional[str] = None
        try:
            replica.start()
            if getattr(replica.spec, "role", "any") != "prefill":
                rid = replica.client.submit(
                    list(self.config.probe_prompt), max_new=2
                )
                deadline = time.time() + self.config.warm_timeout_s
                while time.time() < deadline:
                    snap = replica.client.poll(rid)
                    if snap.get("done"):
                        if snap.get("state") != "done":
                            error = f"probe ended {snap.get('state')!r}"
                        break
                    time.sleep(0.01)
                else:
                    error = "probe timed out"
        except Exception as e:  # noqa: BLE001 - warm failure aborts the event, never the pump
            error = f"{type(e).__name__}: {e}"
        with self._lock:
            if self._warm is not None and self._warm["replica"] is replica:
                self._warm["done"] = True
                self._warm["error"] = error

    def _tick_warming(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            st = self._warm
        if st is None:
            with self._lock:
                self._phase = STEADY
            return
        replica = st["replica"]
        if not st["done"]:
            if now - st["started"] > cfg.warm_timeout_s + 5.0:
                replica.kill()
                self._journal(
                    "fleet.scale.blocked", now, replica=replica.index,
                    reason="warm_timeout",
                )
                self.router.log(
                    f"autoscale: warm timeout on replica {replica.index}; aborted"
                )
                with self._lock:
                    self._warm = None
                    self._phase = STEADY
            return
        if st["error"] is not None:
            replica.kill()
            self._journal(
                "fleet.scale.blocked", now, replica=replica.index,
                reason="warm_failed", error=st["error"],
            )
            self.router.log(
                f"autoscale: warm failed on replica {replica.index}: "
                f"{st['error']}"
            )
            with self._lock:
                self._warm = None
                self._phase = STEADY
            return
        # warmed: admit behind the half-open probation gate
        self.router.admit_replica(replica, probation=True)
        self._journal(
            "fleet.scale.admitted", now, replica=replica.index,
            role=getattr(replica.spec, "role", "any"),
            warm_s=round(now - st["started"], 3),
        )
        with self._lock:
            self._warm = None
            if st["revert"]:
                self._phase = STEADY
            else:
                self._phase = GUARD
                self._guard = {
                    "direction": "up",
                    "since": now,
                    "baseline": st["baseline"],
                    "replica": replica.index,
                }

    # ------------------------------------------------------------- scale-down

    def _pick_victim(self) -> Optional[Replica]:
        """Least-loaded retireable replica. In a disaggregated fleet the
        over-represented role's pool gives up the victim; the last
        decode-capable replica is never a candidate."""
        router = self.router
        with router._lock:
            decode = [
                r for r in router.replicas
                if getattr(r.spec, "role", "any") != "prefill"
                and r.state == UP and r.index not in router._draining
            ]
            prefill = [
                r for r in router.replicas
                if getattr(r.spec, "role", "any") == "prefill"
                and r.state == UP and r.index not in router._draining
            ]
            n_total = len(decode) + len(prefill)
            if self._target_prefill_frac > 0 and n_total > 1:
                frac = len(prefill) / n_total
                if frac > self._target_prefill_frac and len(prefill) > 1:
                    return prefill[-1]
            if len(decode) <= 1:
                return None

            def load(r: Replica) -> Tuple[int, int, int]:
                stats = router._stats_cache.get(r.index) or {}
                return (
                    int(stats.get("active_slots") or 0),
                    int(stats.get("queue_depth") or 0),
                    -r.index,  # tie-break: retire the newest
                )

            return min(decode, key=load)

    def _begin_scale_down(
        self,
        now: float,
        reason: str,
        victim: Optional[Replica] = None,
        revert: bool = False,
    ) -> bool:
        victim = victim or self._pick_victim()
        if victim is None:
            return False
        router = self.router
        baseline = None if revert else self._attainment(now, self.config.guard_window_s)
        router.begin_drain(victim.index)
        with self._lock:
            self._phase = DRAINING
            self._last_event_ts = now
            self._drain = {
                "replica": victim,
                "started": now,
                "spilled": False,
                "revert": revert,
                "baseline": baseline,
                "reason": reason,
            }
            self._journal_locked(
                "fleet.scale.down", now, replica=victim.index,
                role=getattr(victim.spec, "role", "any"),
                reason=reason, revert=revert,
            )
        router.telemetry.count("fleet.scale_events")
        router.log(f"autoscale: draining replica {victim.index} ({reason})")
        return True

    def _tick_draining(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            st = self._drain
        if st is None:
            with self._lock:
                self._phase = STEADY
            return
        victim = st["replica"]
        router = self.router
        ch = chaos_mod.get()
        if (
            victim.state == UP
            and ch is not None
            and ch.replica_kill_mid_drain(victim.index)
        ):
            router.log(
                f"chaos: killing replica {victim.index} mid-drain"
            )
            victim.kill()
        if victim.state != UP:
            # killed mid-drain: the router's down path already requeued its
            # streams (the requeue-on-death fallback); finish the retire bookkeeping
            router.sweep_now()
            router.retire_replica(victim)
            self._finish_drain(now, st, mode="kill_fallback")
            return
        remaining = router.inflight_on(victim.index)
        if remaining and not st["spilled"] and now - st["started"] > cfg.drain_grace_s:
            moved = router.spill_and_requeue(victim.index)
            with self._lock:
                if self._drain is st:
                    st["spilled"] = True
            router.log(
                f"autoscale: drain grace over on replica {victim.index}; "
                f"spilled + requeued {moved} stream(s)"
            )
            remaining = router.inflight_on(victim.index)
        if remaining == 0:
            router.retire_replica(victim, timeout=cfg.drain_timeout_s)
            self._finish_drain(now, st, mode="drained")
            return
        if now - st["started"] > cfg.drain_timeout_s:
            # wedged drain: hard-kill; the down path requeues (fallback)
            router.log(
                f"autoscale: drain timeout on replica {victim.index}; killing"
            )
            victim.kill()

    def _finish_drain(self, now: float, st: Dict[str, Any], mode: str) -> None:
        victim = st["replica"]
        drain_ms = (now - st["started"]) * 1e3
        self.router.telemetry.histogram("fleet.drain_ms", drain_ms)
        self._journal(
            "fleet.scale.retired", now, replica=victim.index, mode=mode,
            drain_ms=round(drain_ms, 1),
        )
        with self._lock:
            self._drain = None
            if st["revert"]:
                self._phase = STEADY
            else:
                self._phase = GUARD
                self._guard = {
                    "direction": "down",
                    "since": now,
                    "baseline": st["baseline"],
                    "replica": victim.index,
                }

    # ----------------------------------------------------------------- guard

    def _tick_guard(self, now: float) -> None:
        """Post-scale trial window, the autopilot controller shape: commit
        when attainment holds, auto-revert the event on regression."""
        cfg = self.config
        with self._lock:
            st = self._guard
        if st is None:
            with self._lock:
                self._phase = STEADY
            return
        if now - st["since"] < cfg.guard_window_s:
            return
        before = st["baseline"]
        after = self._attainment(now, cfg.guard_window_s)
        regressed = (
            before is not None
            and after is not None
            and after < before * (1.0 - cfg.regress_tol)
        )
        if regressed and st["direction"] == "up":
            obs = self.observe(now)
            if obs.brownout_level >= cfg.escalate_level or (
                obs.util is not None and obs.util > cfg.target_util
            ):
                # the regression is explained by the overload the
                # scale-out answered — a storm keeps blowing attainment
                # down while the backlog's doomed requests complete —
                # not by the new replica. Reverting capacity here would
                # fight the brownout ladder (the no-fight rule), so
                # re-arm the window against the degraded level and judge
                # again once pressure moves.
                with self._lock:
                    if self._guard is st:
                        self._guard = {**st, "since": now, "baseline": after}
                self._journal(
                    "fleet.scale.guard_extended", now,
                    direction=st["direction"], replica=st["replica"],
                    brownout=obs.brownout_level,
                    attainment=round(after, 4),
                )
                return
        with self._lock:
            self._guard = None
            self._phase = STEADY
        if not regressed:
            self._journal(
                "fleet.scale.committed", now, direction=st["direction"],
                replica=st["replica"],
                before=None if before is None else round(before, 4),
                after=None if after is None else round(after, 4),
            )
            return
        self._journal(
            "fleet.scale.rollback", now, direction=st["direction"],
            replica=st["replica"], before=round(before, 4),
            after=round(after, 4),
        )
        self.router.log(
            f"autoscale: ROLLBACK scale-{st['direction']} "
            f"(attainment {before:.3f} -> {after:.3f})"
        )
        if st["direction"] == "down":
            # the retired capacity was load-bearing: respawn a replacement
            self._begin_scale_up(now, reason="rollback", revert=True)
        else:
            # the added replica regressed the fleet: drain it back out
            victim = None
            with self.router._lock:
                for r in self.router.replicas:
                    if r.index == st["replica"]:
                        victim = r
                        break
            if victim is not None:
                self._begin_scale_down(
                    now, reason="rollback", victim=victim, revert=True
                )

    # ------------------------------------------------------------------ status

    def snapshot(self) -> Dict[str, Any]:
        """For FSTATS/STATUS and the monitor's autoscale line."""
        cfg = self.config
        with self._lock:
            last = self.events[-1] if self.events else None
            return {
                "phase": self._phase,
                "min_replicas": cfg.min_replicas,
                "max_replicas": cfg.max_replicas,
                "target_util": cfg.target_util,
                "cooldown_s": cfg.scale_cooldown_s,
                "at_capacity": self._at_capacity,
                "last_event": dict(last) if last else None,
                "events": [dict(e) for e in self.events],
            }
