"""Declarative alert rules evaluated over the time-series store.

A copy of :mod:`maggy_tpu.telemetry.alerts`. The rule registry is checked
in: every alert the system can fire is named here, with its condition,
severity, and scope; keep it stdlib-plus-siblings only.

:class:`RecompileSentinel` watches ``Engine.compile_counts``, which in this
package counts the distinct input shapes each serving program ran at (the
shapes a CUDA-graph capture would have to hold): a new decode shape after
warm-up is the same signal a retrace is under XLA.

Three rule kinds:

- ``threshold`` — fire when a gauge series crosses ``op threshold`` and stays
  there for ``for_s`` seconds (for-duration suppresses one-tick blips).
- ``burn_rate`` — multi-window SLO error-budget burn, the Google-SRE shape:
  error rate over a *long* and a *short* window, each divided by the budget
  ``(1 - objective)``; fire only when **both** exceed their factor. The long
  window keeps it significant, the short one makes it resolve fast. The
  error rate comes from a cumulative ok/miss counter pair (TTFT attainment:
  the scheduler's ``serve.slo_ok``/``serve.slo_miss``) or from a latency
  histogram series plus an SLO bound (TPOT attainment).
- ``sentinel`` — fired directly by :class:`RecompileSentinel`, not evaluated
  from a series; registered here so the name, severity, and docs table stay
  in one place.

Transitions emit ``alert.firing`` / ``alert.resolved`` events through the
recorder; a transition to firing on a ``critical`` rule triggers a
flight-recorder dump, and every dump embeds the currently-firing set plus
the recent samples of the metrics those alerts name (see
``telemetry/flightrec.py``).
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

ALERT_FIRING = "alert.firing"
ALERT_RESOLVED = "alert.resolved"

KINDS = ("threshold", "burn_rate", "sentinel")
SEVERITIES = ("warning", "critical")
SCOPES = ("worker", "fleet", "any")


@dataclass(frozen=True)
class Rule:
    """One checked-in alert rule. ``name`` must be ``alert.<slug>``."""

    name: str
    summary: str  # one line, shown on the monitor ALERTS line and in dumps
    kind: str = "threshold"
    severity: str = "warning"
    scope: str = "any"  # worker / fleet / any (evaluated at both)
    # threshold rules
    metric: Optional[str] = None  # gauge series name
    op: str = ">"
    threshold: float = 0.0
    for_s: float = 0.0  # condition must hold this long before firing
    # burn_rate rules — counter-pair source ...
    ok_metric: Optional[str] = None
    miss_metric: Optional[str] = None
    # ... or histogram source (metric = hist series name + slo_ms bound)
    slo_ms: Optional[float] = None
    objective: float = 0.99  # target attainment; budget = 1 - objective
    # ((window_s, burn_factor), ...) — all windows must exceed their factor
    windows: Tuple[Tuple[float, float], ...] = ((30.0, 2.0), (5.0, 2.0))

    def metrics(self) -> Tuple[str, ...]:
        """Series names this rule reads (flight-recorder dumps embed their
        recent samples)."""
        out = []
        for m in (self.metric, self.ok_metric, self.miss_metric):
            if m:
                out.append(m)
        return tuple(out)


# The checked-in registry. Adding an alert = add a Rule here (the lint
# validates it and the docs table in docs/observability.md mirrors it).
RULES: Tuple[Rule, ...] = (
    Rule(
        name="alert.queue_depth_high",
        summary="admission queue persistently deep; decode not keeping up",
        kind="threshold",
        metric="serve.queue_depth",
        op=">",
        threshold=64.0,
        for_s=3.0,
        severity="warning",
        scope="worker",
    ),
    Rule(
        name="alert.pages_exhausted",
        summary="paged-KV pool out of free pages; preemption imminent",
        kind="threshold",
        metric="serve.pages_free",
        op="<",
        threshold=1.0,
        for_s=3.0,
        severity="warning",
        scope="worker",
    ),
    Rule(
        name="alert.fleet_no_healthy_replicas",
        summary="router sees zero healthy replicas",
        kind="threshold",
        metric="fleet.healthy_replicas",
        op="<",
        threshold=1.0,
        for_s=1.0,
        severity="critical",
        scope="fleet",
    ),
    Rule(
        name="alert.fleet_at_capacity",
        summary="scale-out pressure pinned at max_replicas; brownout is the only relief",
        kind="threshold",
        metric="fleet.at_capacity",
        op=">",
        threshold=0.0,
        for_s=5.0,
        severity="warning",
        scope="fleet",
    ),
    Rule(
        name="alert.ttft_slo_burn",
        summary="TTFT SLO error budget burning in short and long windows",
        kind="burn_rate",
        ok_metric="serve.slo_ok",
        miss_metric="serve.slo_miss",
        objective=0.99,
        windows=((30.0, 2.0), (5.0, 2.0)),
        severity="critical",
        scope="any",
    ),
    Rule(
        name="alert.tpot_slo_burn",
        summary="per-token decode latency burning its attainment budget",
        kind="burn_rate",
        metric="serve.tpot_ms",
        slo_ms=200.0,
        objective=0.99,
        windows=((30.0, 3.0), (5.0, 3.0)),
        severity="warning",
        scope="any",
    ),
    Rule(
        name="alert.hbm_headroom",
        summary="HBM headroom below the low-water mark; capacity budget burning",
        kind="burn_rate",
        # counter pair synthesized by the memory ledger's reconcile tick
        # (telemetry/memtrack.py): a tick with headroom under the low-water
        # mark counts as a miss — the multi-window burn shape then gives
        # sustained pressure a fast page and a one-tick dip nothing
        ok_metric="mem.headroom_ok",
        miss_metric="mem.headroom_miss",
        objective=0.90,
        windows=((30.0, 2.0), (5.0, 2.0)),
        severity="critical",
        scope="worker",
    ),
    Rule(
        name="alert.fragmentation",
        summary="paged-KV free pool fragmented; large admissions may thrash",
        kind="threshold",
        metric="serve.fragmentation",
        op=">",
        threshold=0.5,
        for_s=3.0,
        severity="warning",
        scope="worker",
    ),
    Rule(
        name="alert.brownout",
        summary="fleet degrading best-effort traffic (brownout ladder > normal)",
        kind="threshold",
        metric="fleet.brownout_level",
        op=">",
        threshold=0.0,
        for_s=0.0,
        severity="warning",
        scope="fleet",
    ),
    Rule(
        name="alert.recompile",
        summary="jitted program retraced outside a reconfigure window",
        kind="sentinel",
        severity="critical",
        scope="any",
    ),
)

BY_NAME: Dict[str, Rule] = {r.name: r for r in RULES}

# live evaluators/sentinels, so flight-recorder dumps can embed the firing
# set without plumbing references through every call site
_EVALUATORS: "weakref.WeakSet" = weakref.WeakSet()


def active_alerts() -> List[Dict[str, Any]]:
    """Currently-firing alerts across every live evaluator in the process."""
    out: List[Dict[str, Any]] = []
    for ev in list(_EVALUATORS):
        try:
            out.extend(ev.firing())
        except Exception:
            continue
    return out


def alerted_series_tails(n: int = 32) -> Dict[str, List]:
    """Last ``n`` samples of every series named by a firing alert, keyed
    ``<scope>/<metric>`` — what makes a stall dump self-describing."""
    out: Dict[str, List] = {}
    for ev in list(_EVALUATORS):
        try:
            store = ev.store
            for a in ev.firing():
                rule = BY_NAME.get(a.get("alert", ""))
                if rule is None or store is None:
                    continue
                for m in rule.metrics():
                    s = store.get(m)
                    if s is not None:
                        out[f"{ev.scope}/{m}"] = [[ts, v] for ts, v in s.tail(n)]
        except Exception:
            continue
    return out


class AlertEvaluator:
    """Evaluates the registry against one :class:`SeriesStore` at one scope.

    Owned by whatever owns the store (scheduler loop, router pump) and
    ticked from that thread; ``firing()`` is safe to call from RPC threads
    (it copies under the GIL)."""

    def __init__(
        self,
        store,
        recorder=None,
        scope: str = "worker",
        rules: Optional[Tuple[Rule, ...]] = None,
        stale_s: float = 30.0,
    ):
        self.store = store
        self.scope = scope
        self._tel = recorder
        self._stale_s = stale_s
        self._rules = tuple(
            r
            for r in (rules if rules is not None else RULES)
            if r.kind != "sentinel" and r.scope in ("any", scope)
        )
        self._pending: Dict[str, float] = {}  # rule -> condition-true since  # race: ok — single-writer (owner tick thread); never read off-thread
        self._firing: Dict[str, Dict[str, Any]] = {}  # race: ok — single-writer (owner tick); firing() copies dicts under the GIL
        _EVALUATORS.add(self)

    # ------------------------------------------------------------------- read

    def firing(self) -> List[Dict[str, Any]]:
        return [dict(v) for v in list(self._firing.values())]

    # ------------------------------------------------------------------- tick

    def evaluate(self, now: Optional[float] = None, watchdog=None) -> List[Dict[str, Any]]:  # thread-entry — ticked from the owning scheduler/router thread
        """One evaluation pass; returns the transitions (fired/resolved)."""
        ts = now if now is not None else time.time()
        transitions: List[Dict[str, Any]] = []
        for rule in self._rules:
            if rule.kind == "threshold":
                cond, value = self._eval_threshold(rule, ts)
            else:
                cond, value = self._eval_burn(rule, ts)
            transitions.extend(self._transition(rule, cond, value, ts, watchdog))
        return transitions

    # ----------------------------------------------------------- rule kinds

    def _eval_threshold(self, rule: Rule, ts: float) -> Tuple[bool, Optional[float]]:
        s = self.store.get(rule.metric) if rule.metric else None
        latest = s.latest() if s is not None else None
        if latest is None or ts - latest[0] > self._stale_s:
            return False, None
        value = float(latest[1])
        cond = value > rule.threshold if rule.op == ">" else value < rule.threshold
        if not cond:
            self._pending.pop(rule.name, None)
            return False, value
        since = self._pending.setdefault(rule.name, ts)
        return ts - since >= rule.for_s, value

    def _eval_burn(self, rule: Rule, ts: float) -> Tuple[bool, Optional[float]]:
        """Error-budget burn in every window must exceed its factor."""
        budget = max(1e-9, 1.0 - rule.objective)
        worst: Optional[float] = None
        for window_s, factor in rule.windows:
            err = self._error_rate(rule, window_s, ts)
            if err is None:
                return False, worst
            burn = err / budget
            worst = burn if worst is None else max(worst, burn)
            if burn <= factor:
                return False, worst
        return True, worst

    def _error_rate(self, rule: Rule, window_s: float, ts: float) -> Optional[float]:
        if rule.ok_metric and rule.miss_metric:
            ok_s = self.store.get(rule.ok_metric)
            miss_s = self.store.get(rule.miss_metric)
            if ok_s is None or miss_s is None:
                return None
            ok = ok_s.delta(window_s, ts)
            miss = miss_s.delta(window_s, ts)
            if ok is None or miss is None or ok + miss <= 0:
                return None
            return miss / (ok + miss)
        if rule.metric and rule.slo_ms is not None:
            s = self.store.get(rule.metric)
            if s is None:
                return None
            att = s.attainment(rule.slo_ms, window_s, ts)
            return None if att is None else 1.0 - att
        return None

    # ------------------------------------------------------------ transitions

    def _transition(
        self, rule: Rule, cond: bool, value: Optional[float], ts: float, watchdog
    ) -> List[Dict[str, Any]]:
        firing = rule.name in self._firing
        if cond and not firing:
            rec = {
                "alert": rule.name,
                "severity": rule.severity,
                "scope": self.scope,
                "since": round(ts, 3),
                "value": None if value is None else round(value, 4),
                "summary": rule.summary,
            }
            self._firing[rule.name] = rec
            self._emit(ALERT_FIRING, rule, value)
            if rule.severity == "critical":
                self._dump(rule, watchdog)
            return [dict(rec, event=ALERT_FIRING)]
        if not cond and firing:
            rec = self._firing.pop(rule.name)
            self._pending.pop(rule.name, None)
            self._emit(ALERT_RESOLVED, rule, value)
            return [dict(rec, event=ALERT_RESOLVED)]
        if cond and firing and value is not None:
            self._firing[rule.name]["value"] = round(value, 4)
        return []

    def _emit(self, event: str, rule: Rule, value: Optional[float]) -> None:
        tel = self._tel
        if tel is None:
            return
        try:
            tel.event(
                event,
                alert=rule.name,
                severity=rule.severity,
                scope=self.scope,
                value=None if value is None else round(value, 4),
            )
        except Exception:  # noqa: BLE001 - alerting must never kill the loop
            pass

    def _dump(self, rule: Rule, watchdog) -> None:
        try:
            if watchdog is None:
                from . import flightrec

                watchdog = flightrec.get()
            watchdog.dump(f"alert:{rule.name}")
        except Exception:  # noqa: BLE001 - a failed dump must not kill serving
            pass


class RecompileSentinel:
    """Turns the "compiles ONCE" test invariants into a production guardrail.

    Feed it the compile counts per jitted program (engine
    ``compile_counts``, trainer ``compile_counts``) each tick; every count
    becomes a ``compile.<program>`` series, and an *unexpected* increase on
    a steady program fires ``alert.recompile``. Expected recompiles — the
    first warm compile, and anything inside an :meth:`expect` window
    (reconfigure, explicit step-function invalidation) — re-baseline
    silently. Bucketed programs (prefill ladders) are tracked as series but
    never alerted: their compile ladder is by design.
    """

    RULE = BY_NAME["alert.recompile"]
    HOLD_S = 30.0  # how long a tripped sentinel stays on the ALERTS line

    def __init__(self, store, recorder=None, scope: str = "worker", steady=("decode", "admit")):
        self.store = store
        self.scope = scope
        self._tel = recorder
        self._steady = tuple(steady)
        self._baseline: Dict[str, int] = {}  # race: ok — single-writer (owner tick thread); GIL-atomic dict stores
        self._expected: set = set()  # race: ok — expect() runs on the owner thread before its own tick observes the counts
        self._tripped: Dict[str, float] = {}  # program -> fired at  # race: ok — single-writer tick; firing() iterates a list() copy
        _EVALUATORS.add(self)

    def expect(self, *programs: str) -> None:
        """Mark the next compile-count increase as legitimate (call before
        ``reconfigure`` or a deliberate step rebuild). No args = all steady
        programs."""
        self._expected.update(programs or self._steady)

    def firing(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = time.time() if now is None else now
        out = []
        for prog, ts in list(self._tripped.items()):
            if now - ts > self.HOLD_S:
                del self._tripped[prog]
                self._emit(ALERT_RESOLVED, prog, self._baseline.get(prog, 0))
                continue
            out.append(
                {
                    "alert": self.RULE.name,
                    "severity": self.RULE.severity,
                    "scope": self.scope,
                    "since": round(ts, 3),
                    "value": float(self._baseline.get(prog, 0)),
                    "summary": f"{prog}: {self.RULE.summary}",
                    "program": prog,
                }
            )
        return out

    def observe(  # thread-entry — ticked from the owning scheduler/router thread
        self, counts: Dict[str, int], now: Optional[float] = None, watchdog=None
    ) -> List[str]:
        """Record one tick of compile counts; returns programs that tripped."""
        ts = now if now is not None else time.time()
        tripped: List[str] = []
        for prog, c in (counts or {}).items():
            c = int(c)
            if self.store is not None:
                self.store.series(f"compile.{prog}", "counter").append(ts, float(c))
            base = self._baseline.get(prog)
            if base is None or c <= base:
                if base is None:
                    self._baseline[prog] = c
                continue
            self._baseline[prog] = c
            if prog in self._expected:
                self._expected.discard(prog)
                continue
            if prog not in self._steady or base == 0:
                continue  # bucketed ladder or the warm first compile
            self._tripped[prog] = ts
            tripped.append(prog)
            self._emit(ALERT_FIRING, prog, c)
            self._dump(prog, watchdog)
        return tripped

    def _emit(self, event: str, prog: str, count: int) -> None:
        tel = self._tel
        if tel is None:
            return
        try:
            tel.event(
                event,
                alert=self.RULE.name,
                severity=self.RULE.severity,
                scope=self.scope,
                program=prog,
                count=int(count),
            )
        except Exception:  # noqa: BLE001 - alerting must never kill the loop
            pass

    def _dump(self, prog: str, watchdog) -> None:
        try:
            if watchdog is None:
                from . import flightrec

                watchdog = flightrec.get()
            watchdog.dump(f"alert:{self.RULE.name}:{prog}")
        except Exception:  # noqa: BLE001 - a failed dump must not kill serving
            pass
