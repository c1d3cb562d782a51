"""Deterministic chaos harness: scripted faults on an env/config seam.

Every recovery path in the runtime (trial requeue, worker quarantine,
elastic restart, auto-resume, checkpoint fallback, heartbeat liveness) must
be testable on a CPU dev box where nothing ever actually gets preempted.
This module injects the failures deterministically: a :class:`Chaos` plan is
a list of :class:`Fault` rules, each firing a bounded number of times when
its match keys line up — same plan, same execution, same faults.

Seams (all zero-cost when no plan is installed):

* ``Trainer.fit`` calls :meth:`Chaos.kill` each step — a matching ``kill``
  rule raises :class:`WorkerKilled` (a :class:`~maggy_tpu_torch.exceptions.WorkerLost`),
  which executors treat as worker death, not a trial error.
* ``rpc.Client._send_beat`` consults ``hb_drop`` — the beat is silently
  skipped, simulating a silent/preempted worker to the driver's liveness
  sweep.
* ``rpc.Server._dispatch`` consults ``rpc_stall`` — the matching verb's
  reply is delayed by ``secs`` (this deliberately blocks the server loop;
  chaos is a test harness, never production instrumentation).
* :func:`truncate_checkpoint` corrupts a saved step in place so the
  ``Checkpointer.restore`` fallback path can be exercised.
* The serving fleet router consults ``replica_kill`` — the matching
  replica's RPC port closes and its scheduler is abandoned mid-decode,
  simulating a preempted serving host (the router must requeue its
  in-flight requests to survivors; docs/fleet.md).
* The serve scheduler consults ``replica_slow`` per admission — a gray
  (slow-but-alive) replica whose own TTFT telemetry absorbs the injected
  latency, which is what the router's circuit breaker scores
  (docs/resilience.md "Gray failure & circuit breakers").
* The traffic generator (``serve/loadgen.py``) consults ``tenant_burst``
  while building a schedule — one tenant's offered load is multiplied,
  driving the brownout ladder without a bespoke traffic spec.
* The host-DRAM KV tier (``serve/tier/host_pool.py``) consults
  ``host_pool_slow`` per pack fill — swap-in latency lands in admission
  TTFT, exercising the tier's degraded-but-correct path (docs/serving.md
  "Host-DRAM page tier").
* The fleet autoscaler (``serve/fleet/autoscale.py``) consults
  ``replica_spawn_slow`` before warming a spawned replica (slow host
  acquisition / cold compile cache — the probation gate must hold) and
  ``replica_kill_mid_drain`` each drain tick (a scale-in victim dying
  mid-drain must fall back to the requeue-on-death path; docs/fleet.md
  "Autoscaling").
* ``Trainer.fit`` consults ``slice_drop`` / ``slice_rejoin`` each step when
  running under an elastic membership monitor — a matching ``slice_drop``
  raises :class:`~maggy_tpu_torch.resilience.membership.SliceLost` (the slice's
  devices are gone: fall back to the last retained checkpoint), a matching
  ``slice_rejoin`` re-admits a previously dropped slice gracefully (fit
  checkpoints first). Both drive the mesh-reshape protocol end to end
  (docs/resilience.md "Elastic membership").

Activation: install programmatically (``chaos.install(Chaos.parse(spec))``)
or via ``MAGGY_TPU_CHAOS=<spec>`` in the environment — the env seam reaches
subprocess workers the same way the telemetry flag does. Spec grammar::

    MAGGY_TPU_CHAOS="kill:worker=1,step=3;hb_drop:worker=0,times=5;rpc_stall:verb=GET,secs=0.2"
    MAGGY_TPU_CHAOS="slice_drop:slice=1,step=4;slice_rejoin:slice=1,step=8"

Rules are ``kind:key=value,...`` joined by ``;``. ``times`` bounds firings
(default 1); omitted match keys match anything. Every kind must be declared
in :data:`KINDS` — ``tools/check_chaos_kinds.py`` (tier-1) closes the kind
set the same way the telemetry-name lint closes the metric set, so a typo'd
kind (``slice_dorp``) fails the lint instead of silently never firing.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from maggy_tpu_torch.exceptions import WorkerLost

ENV_VAR = "MAGGY_TPU_CHAOS"

# The closed set of chaos kinds. Every rule a spec names and every
# ``Chaos.fire(kind, ...)`` seam in maggy_tpu_torch/ and tests/ must use a kind
# declared here — tools/check_chaos_kinds.py lints both sides (tier-1).
# Adding a fault kind = declare it here + add its seam method below.
KINDS = frozenset(
    {
        "kill",  # raise WorkerKilled in Trainer.fit (worker N at step K)
        "hb_drop",  # swallow a worker's next heartbeat (silent worker)
        "rpc_stall",  # delay one verb's reply (wedged driver host)
        "replica_kill",  # kill a serving fleet replica mid-stream
        "slice_drop",  # a slice leaves the elastic data mesh at step K
        "slice_rejoin",  # a dropped slice comes back at step K
        "replica_slow",  # gray failure: delay replica N's admissions by ms=K
        "tenant_burst",  # multiply tenant T's offered load by mult=M (loadgen)
        "host_pool_slow",  # delay host-DRAM KV tier swap-ins by ms=K
        "replica_spawn_slow",  # delay an autoscaler spawn's warm-up by secs=K
        "replica_kill_mid_drain",  # kill replica N while its drain is in progress
    }
)


class WorkerKilled(WorkerLost):
    """Chaos-injected worker death (stands in for preemption/host loss)."""


@dataclasses.dataclass
class Fault:
    """One scripted fault: fire ``kind`` up to ``times`` times whenever every
    entry of ``match`` equals the observed attribute (string-compared)."""

    kind: str
    match: Dict[str, str] = dataclasses.field(default_factory=dict)
    times: int = 1
    arg: float = 0.0  # rule payload (e.g. rpc_stall seconds)


class Chaos:
    """A deterministic fault plan; thread-safe, fires each rule exactly its
    budgeted number of times."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, Dict[str, Any]]] = []

    @classmethod
    def parse(cls, spec: str) -> "Chaos":
        faults = []
        for rule in spec.split(";"):
            rule = rule.strip()
            if not rule:
                continue
            kind, _, rest = rule.partition(":")
            match: Dict[str, str] = {}
            times, arg = 1, 0.0
            for pair in filter(None, (p.strip() for p in rest.split(","))):
                key, sep, value = pair.partition("=")
                if not sep:
                    raise ValueError(
                        f"chaos rule {rule!r}: expected key=value, got {pair!r}"
                    )
                if key == "times":
                    times = int(value)
                elif key == "secs":
                    arg = float(value)
                elif key == "ms":
                    # latency payloads (replica_slow) are spelled in ms on
                    # the wire but carried in seconds like secs
                    arg = float(value) / 1e3
                elif key == "mult":
                    # rate-multiplier payload (tenant_burst)
                    arg = float(value)
                else:
                    match[key.strip()] = value.strip()
            kind = kind.strip()
            if kind not in KINDS:
                raise ValueError(
                    f"chaos rule {rule!r}: unknown kind {kind!r} "
                    f"(declared kinds: {sorted(KINDS)})"
                )
            faults.append(Fault(kind, match, times=times, arg=arg))
        return cls(faults)

    def fire(self, kind: str, **attrs: Any) -> Optional[Fault]:
        """Consume one firing of the first live rule of ``kind`` matching
        ``attrs``; None when no rule applies."""
        with self._lock:
            for fault in self.faults:
                if fault.kind != kind or fault.times <= 0:
                    continue
                if all(
                    str(attrs.get(key)) == value
                    for key, value in fault.match.items()
                ):
                    fault.times -= 1
                    self.fired.append((kind, dict(attrs)))
                    return fault
        return None

    # ------------------------------------------------------------- seam API

    def kill(self, worker: Any, step: Optional[int] = None) -> None:
        """Raise :class:`WorkerKilled` when a ``kill`` rule matches."""
        if self.fire("kill", worker=worker, step=step) is not None:
            raise WorkerKilled(
                f"chaos: killed worker {worker}"
                + (f" at step {step}" if step is not None else "")
            )

    def drop_heartbeat(self, worker: Any) -> bool:
        """True when this worker's next heartbeat should be swallowed."""
        return self.fire("hb_drop", worker=worker) is not None

    def rpc_stall(self, verb: str) -> float:
        """Seconds to stall the reply to ``verb`` (0.0 = no stall)."""
        fault = self.fire("rpc_stall", verb=verb)
        return fault.arg if fault is not None else 0.0

    def replica_kill(self, replica: Any) -> bool:
        """True when this serving replica should drop dead (the fleet
        router's pump consults it only while the replica is mid-stream, so
        a matching rule always exercises requeue-to-survivors)."""
        return self.fire("replica_kill", replica=replica) is not None

    def replica_spawn_slow(self, replica: Any) -> float:
        """Seconds to delay a freshly spawned replica's warm-up (0.0 =
        none). The autoscaler's warm worker consults it before building
        the new engine, standing in for a slow host acquisition or a cold
        compile cache — the probation gate and warm timeout must hold the
        replica out of dispatch the whole time:
        ``replica_spawn_slow:replica=2,secs=1``."""
        fault = self.fire("replica_spawn_slow", replica=replica)
        return fault.arg if fault is not None else 0.0

    def replica_kill_mid_drain(self, replica: Any) -> bool:
        """True when this replica should drop dead mid-drain. The
        autoscaler's drain loop consults it each tick while the victim
        still holds in-flight streams, so a matching rule always lands
        between dispatch-stop and retire — exercising the fallback from
        graceful drain to the router's requeue-on-death path:
        ``replica_kill_mid_drain:replica=1``."""
        return self.fire("replica_kill_mid_drain", replica=replica) is not None

    def replica_slow(self, replica: Any) -> float:
        """Seconds of gray-failure latency to inject into this replica's
        next admission (0.0 = none). The scheduler consults it per admitted
        request, so the slow replica's own TTFT histograms absorb the
        delay — exactly the signal the router's circuit breaker scores
        (docs/resilience.md "Gray failure"). Spell sustained slowness with
        ``times=N``: ``replica_slow:replica=1,ms=300,times=50``."""
        fault = self.fire("replica_slow", replica=replica)
        return fault.arg if fault is not None else 0.0

    def host_pool_slow(self) -> float:
        """Seconds of swap-in latency to inject into the next host-DRAM KV
        tier fill (0.0 = none). ``HostPagePool.get`` consults it per pack
        fill — outside its lock — so a slow host-memory path surfaces as
        admission TTFT, the same signal a genuinely DMA-bound swap-in
        would produce: ``host_pool_slow:ms=50,times=10``."""
        fault = self.fire("host_pool_slow")
        return fault.arg if fault is not None else 0.0

    def tenant_burst(self, tenant: Any) -> float:
        """Offered-load multiplier for this tenant (1.0 = no burst). The
        traffic generator consults it while building a schedule, so a burst
        scenario is spelled as chaos instead of a bespoke spec:
        ``tenant_burst:tenant=bulk,mult=5``."""
        fault = self.fire("tenant_burst", tenant=tenant)
        if fault is None or fault.arg <= 0:
            return 1.0
        return fault.arg

    def slice_drop(self, slices, step: Optional[int] = None) -> Optional[Any]:
        """The id of the ACTIVE slice a ``slice_drop`` rule kills at this
        step (None = no rule fired). At most one slice drops per call — a
        multi-slice outage is spelled as multiple rules firing on
        consecutive steps, which exercises the reshape path once per loss
        the way real preemptions arrive."""
        for s in slices:
            if self.fire("slice_drop", slice=s, step=step) is not None:
                return s
        return None

    def slice_rejoin(self, slices, step: Optional[int] = None) -> Optional[Any]:
        """The id of the INACTIVE slice a ``slice_rejoin`` rule re-admits
        at this step (None = no rule fired)."""
        for s in slices:
            if self.fire("slice_rejoin", slice=s, step=step) is not None:
                return s
        return None


def truncate_checkpoint(directory: str, step: Optional[int] = None) -> int:
    """Corrupt a saved checkpoint step in place (default: the latest) by
    truncating every payload file under it to half size — the on-disk shape
    of a save interrupted mid-write. Returns the corrupted step."""
    steps = sorted(int(name) for name in os.listdir(directory) if name.isdigit())
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {directory}")
    step = int(step) if step is not None else steps[-1]
    root = os.path.join(directory, str(step))
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 2)
    return step


# ------------------------------------------------------------------ registry

_lock = threading.Lock()
_active: Optional[Chaos] = None
_env_resolved = False


def install(chaos: Optional[Chaos]) -> None:
    """Install (or clear, with None) the process-wide fault plan."""
    global _active, _env_resolved
    with _lock:
        _active = chaos
        _env_resolved = True  # explicit install wins over the env seam


def get() -> Optional[Chaos]:
    """The active fault plan, lazily parsed from ``MAGGY_TPU_CHAOS`` once.
    None (the overwhelmingly common case) costs one attribute read."""
    global _active, _env_resolved
    if _env_resolved:
        return _active
    with _lock:
        if not _env_resolved:
            spec = os.environ.get(ENV_VAR, "")
            _active = Chaos.parse(spec) if spec else None
            _env_resolved = True
    return _active


def reset() -> None:
    """Clear the plan AND re-arm the env seam (test isolation)."""
    global _active, _env_resolved
    with _lock:
        _active = None
        _env_resolved = False
