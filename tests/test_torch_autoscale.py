"""The port's fleet autoscaler (``maggy_tpu_torch.serve.fleet.autoscale``)
against the JAX package's, on the CPU.

``Autoscaler.decide`` over the same ``Observation`` sequences gives JAX's
decisions and journal exactly (brownout handoff, hysteresis holds,
cooldown, min/max clamps, headroom gates, the seeded diurnal+burst replay);
the router's scale seams (respawn, drain, retire, admit, rebalance) leave
the same state over fake replicas; the chaos seams ``replica_spawn_slow``
and ``replica_kill_mid_drain`` fire alike. Then one in-process scale-up
behind the probation gate and one drain-safe scale-in on the tiny model,
with streams equal to JAX's ``generate_cached``. Every wait has a timeout.
"""

import dataclasses
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import transformer as jt
from maggy_tpu.models.generate import generate_cached
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu.resilience import chaos as jchaos
from maggy_tpu.serve import loadgen as jloadgen
from maggy_tpu.serve.fleet import autoscale as jautoscale
from maggy_tpu.serve.fleet import router as jrouter
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.resilience import chaos
from maggy_tpu_torch.serve import ServeClient
from maggy_tpu_torch.serve import loadgen
from maggy_tpu_torch.serve.fleet import AutoscaleConfig, ReplicaSpec, RouterConfig, launch_fleet
from maggy_tpu_torch.serve.fleet import autoscale as tautoscale
from maggy_tpu_torch.serve.fleet import router as trouter
from maggy_tpu_torch.serve.fleet.replica import BREAKER_CLOSED, BREAKER_HALF_OPEN, DEAD, UP

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CFG = tt.DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)


# ------------------------------------------------------------ decision ladder


def bare_autoscaler(mod, **cfg_kwargs):
    """An Autoscaler over a stub router: decide() touches no fleet state."""
    router = types.SimpleNamespace(
        replicas=[],
        telemetry=types.SimpleNamespace(event=lambda *a, **k: None, count=lambda *a, **k: None),
    )
    return mod.Autoscaler(router, config=mod.AutoscaleConfig(**cfg_kwargs))


def obs(mod, now, replicas=2, util=0.5, queue=0, level=0, headroom=0.5):
    return mod.Observation(now=float(now), replicas=replicas, util=util, queue_depth=queue,
                           brownout_level=level, headroom_pct=headroom)


# (config, [Observation kwargs]) — the sequences of the JAX package's own
# ladder tests, plus edges of each clock
LADDER = {
    "sustained_brownout": (dict(escalate_hold_s=4.0, high_hold_s=3.0),
                           [dict(now=0.0, level=2), dict(now=2.0, level=2), dict(now=4.0, level=2)]),
    "brownout_blip": (dict(escalate_hold_s=4.0),
                      [dict(now=0.0, level=2), dict(now=3.0, level=0), dict(now=5.0, level=3),
                       dict(now=8.0, level=3), dict(now=9.0, level=3)]),
    "high_util": (dict(high_hold_s=3.0, target_util=0.8),
                  [dict(now=0.0, util=0.95), dict(now=2.0, util=0.5), dict(now=3.0, util=0.95),
                   dict(now=6.0, util=0.95)]),
    "recovery_before_scale_in": (dict(low_hold_s=6.0),
                                 [dict(now=0.0, util=0.1, level=2), dict(now=1.0, util=0.1, level=1),
                                  dict(now=2.0, util=0.1, level=1), dict(now=3.0, util=0.1, level=0),
                                  dict(now=8.5, util=0.1, level=0), dict(now=9.0, util=0.1, level=0)]),
    "empty_queue": (dict(low_hold_s=2.0),
                    [dict(now=0.0, util=0.1), dict(now=1.0, util=0.1, queue=3), dict(now=2.0, util=0.1),
                     dict(now=4.0, util=0.1)]),
    "headroom": (dict(low_hold_s=1.0, min_headroom_pct=0.05),
                 [dict(now=0.0, util=0.1, headroom=0.01), dict(now=1.0, util=0.1, headroom=0.01),
                  dict(now=1.2, util=0.1, headroom=0.40), dict(now=1.3, util=0.1, headroom=None)]),
    "survivors_hot": (dict(low_hold_s=1.0, target_util=0.4, low_util=0.35),
                      [dict(now=0.0, replicas=2, util=0.3), dict(now=1.5, replicas=2, util=0.3),
                       dict(now=2.0, replicas=3, util=0.2), dict(now=3.5, replicas=3, util=0.2)]),
    "max_clamp": (dict(max_replicas=2, escalate_hold_s=1.0),
                  [dict(now=0.0, replicas=2, level=2), dict(now=1.0, replicas=2, level=2),
                   dict(now=2.0, replicas=2, level=2), dict(now=3.0, replicas=2, level=0),
                   dict(now=4.0, replicas=2, level=2), dict(now=5.0, replicas=2, level=2),
                   dict(now=6.0, replicas=1, level=2)]),
    "min_clamp": (dict(min_replicas=1, low_hold_s=1.0),
                  [dict(now=0.0, replicas=1, util=0.0), dict(now=2.0, replicas=1, util=0.0),
                   dict(now=3.0, replicas=2, util=None), dict(now=5.0, replicas=2, util=0.0)]),
}


def run_ladder(mod, cfg, rows):
    """Each row's decision and at_capacity(), then the journal."""
    a = bare_autoscaler(mod, **cfg)
    out = []
    for row in rows:
        out.append((a.decide(obs(mod, **row)), a.at_capacity()))
    return out, [dict(e) for e in a.events]


@pytest.mark.parametrize("name", sorted(LADDER))
def test_decide_equals_jax(name):
    cfg, rows = LADDER[name]
    port = run_ladder(tautoscale, cfg, rows)
    assert port == run_ladder(jautoscale, cfg, rows)
    assert any(action for action, _ in port[0]) == (name != "min_clamp")


@pytest.mark.parametrize("seed", [7, 11])
def test_burst_replay_decisions_equal_jax(seed):
    """The seeded diurnal+burst schedule (each package's own loadgen) as a
    utilization series: the same scale events, each pair separated by the
    cooldown, at least one scale-out."""
    def replay(mod, lg):
        per_sec = [0] * 60
        for arrival in lg.generate(lg.diurnal_burst_spec(seed=seed, duration_s=60.0, base_rps=3.0,
                                                         burst_mult=6.0)):
            per_sec[min(59, int(arrival.at_s))] += 1
        a = bare_autoscaler(mod, max_replicas=4, scale_cooldown_s=10.0, escalate_hold_s=4.0,
                            high_hold_s=2.0, low_hold_s=5.0)
        replicas, events = 1, []
        for sec, rate in enumerate(per_sec):
            action = a.decide(obs(mod, float(sec), replicas=replicas, util=min(1.0, rate / (3.0 * replicas))))
            if action:
                replicas += 1 if action == "up" else -1
                a._last_event_ts = float(sec)
                events.append((sec, action))
        return events

    events = replay(tautoscale, loadgen)
    assert events == replay(jautoscale, jloadgen)
    assert any(kind == "up" for _, kind in events)
    assert all(b - a >= 10 for (a, _), (b, _) in zip(events, events[1:]))


def test_guard_defers_rollback_while_storm_persists():
    def run(mod):
        a = bare_autoscaler(mod, guard_window_s=1.0, regress_tol=0.1)
        a._guard = {"direction": "up", "since": 0.0, "baseline": 0.9, "replica": 7}
        a._attainment = lambda now, w: 0.1
        a.observe = lambda now: obs(mod, now, level=3)
        a._tick_guard(2.0)
        deferred = dict(a._guard)
        a.observe = lambda now: obs(mod, now, level=0, util=0.2)
        a._attainment = lambda now, w: 0.6
        a._tick_guard(4.0)
        return deferred, a._guard, [dict(e) for e in a.events]

    port = run(tautoscale)
    assert port == run(jautoscale)
    assert port[0]["baseline"] == 0.1 and port[1] is None
    assert [e["event"] for e in port[2]] == ["fleet.scale.guard_extended", "fleet.scale.committed"]


# ----------------------------------------------------------------- chaos seams


@pytest.mark.parametrize("spec, kind, calls", [
    ("replica_spawn_slow:replica=2,secs=0.5", "replica_spawn_slow", (1, 2, 2)),
    ("replica_kill_mid_drain:replica=1", "replica_kill_mid_drain", (0, 1, 1)),
    ("replica_slow:replica=0,secs=0.25,times=2", "replica_slow", (1, 0, 0, 0)),
])
def test_chaos_seams_equal_jax(spec, kind, calls):
    def run(mod):
        ch = mod.Chaos.parse(spec)
        return kind in mod.KINDS, [getattr(ch, kind)(i) for i in calls]

    assert run(chaos) == run(jchaos)
    assert run(chaos)[0]


# ---------------------------------------------- router scale seams, fake replicas


def fake_replica(index, state=UP, num_slots=4):
    return types.SimpleNamespace(
        index=index, state=state,
        spec=types.SimpleNamespace(num_slots=num_slots, role="any"),
        describe=lambda: {"replica": index, "state": state, "addr": None,
                          "restarts": 0, "devices": [], "uptime_s": 0.0},
        client=None,
        stop=lambda drain=True, timeout=30.0: None,
        kill=lambda: None,
        respawn=lambda: ("127.0.0.1", 9999),
    )


def seam_respawn(mod, draining):
    dead = fake_replica(0, state=DEAD)
    router = mod.Router([dead], config=mod.RouterConfig(max_restarts=1))
    router.breakers[0].begin_probation(100.0)
    router.breakers[0].take_probe("ghost")
    router.replica_metrics[0] = object()
    if draining:
        router.begin_drain(0)
    router._handle_replica_down(dead)
    return (router.counters["respawned"], router._restarts_used, router.breakers[0].state,
            0 in router.replica_metrics, 0 in router._down_handled)


def seam_retire(mod):
    r0, r1 = fake_replica(0), fake_replica(1)
    router = mod.Router([r0, r1], config=mod.RouterConfig())
    router.prefix_map.update(0, ["d0"])
    router.prefix_map.update(1, ["d1", "shared"])
    router.prefix_map.update(0, ["shared"])
    router._stats_cache[1] = {"active_slots": 0}
    router.begin_drain(1)
    with router._lock:
        draining = router._fleet_stats()["replicas"][1]["state"]
    router.retire_replica(r1)
    with router._lock:
        rows = [row["replica"] for row in router._fleet_stats()["replicas"]]
    return (draining, [r.index for r in router.replicas], sorted(router.breakers), rows,
            router.prefix_map.replicas_for("d1"), router.prefix_map.replicas_for("shared"))


def seam_admit(mod):
    router = mod.Router([fake_replica(0)], config=mod.RouterConfig(slo_ttft_ms=800.0))
    router.admit_replica(fake_replica(5), probation=True)
    return ([r.index for r in router.replicas], router.breakers[5].state,
            router.breakers[5].snapshot(), router.allocate_index())


def seam_rebalance(mod):
    router = mod.Router([fake_replica(0, num_slots=1)], config=mod.RouterConfig())
    for i in range(5):
        router._entries[f"r{i}"] = mod.RouteEntry(rid=f"r{i}", payload={"prompt": [1, 2, 3]},
                                                  state=mod.ROUTED, replica=0, submitted_ts=100.0 + i)
    router._entries["started"] = mod.RouteEntry(rid="started", payload={"prompt": [4]}, state=mod.ROUTED,
                                                replica=0, snapshot={"n_tokens": 2}, submitted_ts=90.0)
    moved = router.rebalance_excess()
    return (moved, list(router._pending), {rid: (e.state, e.replica, e.resubmits)
                                           for rid, e in router._entries.items()},
            router.rebalance_excess())


@pytest.mark.parametrize("seam", [
    lambda mod: seam_respawn(mod, False),
    lambda mod: seam_respawn(mod, True),
    seam_retire,
    seam_admit,
    seam_rebalance,
], ids=["respawn", "respawn_draining", "retire", "admit", "rebalance"])
def test_router_scale_seams_equal_jax(seam):
    assert seam(trouter) == seam(jrouter)


def test_router_scale_seams_hold_their_contracts():
    assert seam_respawn(trouter, False) == (1, 1, BREAKER_CLOSED, False, False)
    assert seam_respawn(trouter, True)[:2] == (0, 0)
    assert seam_admit(trouter)[:2] == ([0, 5], BREAKER_HALF_OPEN)
    assert seam_rebalance(trouter)[:2] == (3, ["r2", "r3", "r4"])


# --------------------------------------------- scale events on real engines

# holds and cooldown pinned far out so decide() never fires on its own: the
# tests drive the scale events directly
EVENT_CFG = dict(min_replicas=1, max_replicas=2, scale_cooldown_s=600.0, escalate_hold_s=600.0,
                 high_hold_s=600.0, low_hold_s=600.0, guard_window_s=0.5, drain_grace_s=0.4,
                 drain_timeout_s=30.0, warm_timeout_s=120.0)


@pytest.fixture(scope="module")
def weights():
    params = unbox(jt.Decoder(JCFG).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"])
    return params, decoder_params_from_flax(jax.device_get(params), CFG)


def reference(params, prompt, max_new):
    decode_model = jt.Decoder(dataclasses.replace(JCFG, decode=True))
    buf = np.zeros((1, len(prompt) + max_new), np.int32)
    buf[0, : len(prompt)] = prompt
    out = generate_cached(decode_model, params, jnp.asarray(buf), jnp.asarray([len(prompt)]))
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_scale_in_drain_is_byte_identical(weights):
    """Drain-based scale-in mid-traffic: every request completes with the
    reference stream, finished on the victim inside the grace or spilled
    and requeued to the survivor; the victim retires."""
    params, state = weights
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12], [13, 14, 15, 16], [3, 1, 4]]
    router = launch_fleet(ReplicaSpec(CFG, state, num_slots=2), replicas=2, device="cpu",
                          autoscale=AutoscaleConfig(**EVENT_CFG))
    addr = router.start(host="127.0.0.1")
    results, errors = {}, []

    def one(i, prompt):
        try:
            time.sleep(0.03 * i)
            with ServeClient(addr, router.secret) as client:
                results[i] = client.generate(prompt, max_new=8, timeout=120)
        except Exception as e:  # noqa: BLE001 - surfaced via the errors list
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        router.autoscaler._begin_scale_down(time.time(), reason="test", victim=router._replica(1))
        for t in threads:
            t.join(timeout=150)
        _wait(lambda: router._replica(1) is None, 60, "the victim's retirement")
        events = [e["event"] for e in router.autoscaler.snapshot()["events"]]
        failed = router.counters["failed"]
    finally:
        router.stop()
    assert not errors, errors
    assert [results[i] for i in range(len(prompts))] == [reference(params, p, 8) for p in prompts]
    assert "fleet.scale.down" in events and "fleet.scale.retired" in events
    assert failed == 0


def test_scale_up_admits_behind_probation_gate(weights):
    """Scale-up warms off the pump (engine build + a probe request) and is
    admitted HALF_OPEN on the spec's shared weights; the first request it
    takes is the canary that closes the breaker; streams equal."""
    params, state = weights
    router = launch_fleet(ReplicaSpec(CFG, state, num_slots=2), replicas=1, device="cpu",
                          config=RouterConfig(slo_ttft_ms=5000.0), autoscale=AutoscaleConfig(**EVENT_CFG))
    addr = router.start(host="127.0.0.1")
    prompts = [[5, 6, 7], [8, 9], [2, 4, 6], [1, 3, 5, 7]]
    try:
        with ServeClient(addr, router.secret) as client:
            client.generate([1, 2, 3], max_new=2, timeout=120)
            router.autoscaler._begin_scale_up(time.time(), reason="test")
            _wait(lambda: len(router.replicas) == 2, 120, "the warmed replica's admission")
            breaker = router.breakers[1]
            admitted_state = breaker.state
            spawned = router._replica(1).server.scheduler.engine
            first = router._replica(0).server.scheduler.engine
            shared = all(spawned.model.state_dict()[n].data_ptr() == t.data_ptr()
                         for n, t in first.model.state_dict().items())
            outs = [client.generate(p, max_new=4, timeout=120) for p in prompts]
            _wait(lambda: breaker.state == BREAKER_CLOSED, 30, "the canary to close the breaker")
        events = [e["event"] for e in router.autoscaler.snapshot()["events"]]
    finally:
        router.stop()
    assert admitted_state == BREAKER_HALF_OPEN and shared
    assert outs == [reference(params, p, 4) for p in prompts]
    assert "fleet.scale.up" in events and "fleet.scale.admitted" in events
