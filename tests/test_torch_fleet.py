"""The port's serving fleet (``maggy_tpu_torch.serve.fleet``) against the JAX
package's, on the CPU.

Float32 ``DecoderConfig.tiny`` with weights converted from the JAX init.
Staggered greedy requests through a port fleet (plain, disaggregated, and
with a replica chaos-killed mid-stream) give the streams of JAX's
``generate_cached`` and of the JAX fleet on the same prompts; replicas on one
device share the serving weights, and a killed replica's engine is freed
without the cyclic collector. The router's decisions (projected TTFT, shed vs
queue admission, requeue order, the POLL ``requeued`` state, the brownout
ladder, the circuit breaker) are held to JAX's exactly on the same inputs,
over fake replicas. Every client call and thread join has its own timeout.
"""

import dataclasses
import gc
import threading
import time
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import transformer as jt
from maggy_tpu.models.generate import generate_cached
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu.resilience import chaos as jchaos
from maggy_tpu.serve import ServeClient as JServeClient
from maggy_tpu.serve.fleet import ReplicaSpec as JReplicaSpec
from maggy_tpu.serve.fleet import launch_fleet as jlaunch_fleet
from maggy_tpu.serve.fleet import replica as jreplica
from maggy_tpu.serve.fleet import router as jrouter
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.monitor import render_status
from maggy_tpu_torch.resilience import chaos
from maggy_tpu_torch.serve import ServeClient
from maggy_tpu_torch.serve.fleet import (
    ReplicaSpec,
    Router,
    RouterConfig,
    build_replicas,
    launch_fleet,
)
from maggy_tpu_torch.serve.fleet import replica as treplica
from maggy_tpu_torch.serve.fleet import router as trouter

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CFG = tt.DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)
PROMPTS = [
    [1, 2, 3, 4],
    [5, 6, 7],
    [9, 10, 11, 12, 13],
    [2, 4, 6, 8, 10, 12],
    [7, 3],
    [20, 21, 22, 23],
    [30, 31],
    [40, 41, 42, 44, 45],
]
MAX_NEW = 5


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


@pytest.fixture(scope="module")
def want(weights):
    params, _ = weights
    return {n: [reference(params, p, n) for p in PROMPTS] for n in (MAX_NEW, 30)}


def drive(client_cls, addr, secret, prompts, max_new, stagger=0.04, timeout=120):
    """Each prompt from its own client thread, ``stagger`` seconds apart;
    returns the streams in prompt order (every join has its timeout)."""
    results, errors = {}, []

    def one(i, prompt):
        try:
            time.sleep(stagger * i)
            with client_cls(addr, secret) as client:
                results[i] = client.generate(prompt, max_new=max_new, timeout=timeout)
        except Exception as e:  # noqa: BLE001 - surfaced via the errors list
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    assert not errors, errors
    assert len(results) == len(prompts)
    return [results[i] for i in range(len(prompts))]


def fleet_status(router, addr):
    with ServeClient(addr, router.secret) as client:
        return client.stats(), client._client.request({"type": "STATUS"})


@pytest.fixture(scope="module")
def jax_fleet_streams(weights):
    params, _ = weights
    router = jlaunch_fleet(JReplicaSpec(JCFG, params, num_slots=2), replicas=2)
    addr = router.start(host="127.0.0.1")
    try:
        return drive(JServeClient, addr, router.secret, PROMPTS, MAX_NEW)
    finally:
        router.stop()


# --------------------------------------------------------------- acceptance


def test_fleet_acceptance(weights, want, jax_fleet_streams):
    """8 staggered requests through 2 replicas == JAX's single-engine
    reference == the JAX fleet; both replicas serve; the monitor's fleet
    panel shows routed=8 and both replica rows."""
    _, state = weights
    router = launch_fleet(ReplicaSpec(CFG, state, num_slots=2), replicas=2, device="cpu")
    addr = router.start(host="127.0.0.1")
    try:
        streams = drive(ServeClient, addr, router.secret, PROMPTS, MAX_NEW)
        stats, status = fleet_status(router, addr)
    finally:
        router.stop()
    assert streams == want[MAX_NEW]
    assert streams == jax_fleet_streams
    assert stats["fleet"] is True
    routing = stats["routing"]
    assert (routing["routed"], routing["completed"], routing["requeued"]) == (8, 8, 0)
    done = [r["requests_done"] for r in stats["replicas"]]
    assert len(done) == 2 and all(n > 0 for n in done), done
    panel = render_status(status)
    assert "fleet:" in panel and "routed=8" in panel
    assert "r0 [" in panel and "r1 [" in panel


def test_fleet_disaggregated(weights, want):
    """1 decode + 1 prefill replica: every prompt prefills on the prefill
    replica and hands its KV pack to the decode replica; streams equal."""
    _, state = weights
    router = launch_fleet(ReplicaSpec(CFG, state, num_slots=2), replicas=1, prefill_replicas=1,
                          device="cpu")
    addr = router.start(host="127.0.0.1")
    try:
        streams = drive(ServeClient, addr, router.secret, PROMPTS, MAX_NEW)
        stats, status = fleet_status(router, addr)
    finally:
        router.stop()
    assert streams == want[MAX_NEW]
    routing = stats["routing"]
    assert routing["prefilled"] == routing["handoffs"] == routing["completed"] == len(PROMPTS)
    assert [r["role"] for r in stats["replicas"]] == ["decode", "prefill"]
    assert router.prefill_workers[0].prefills == len(PROMPTS)
    assert "handoffs=8" in render_status(status)


def test_fleet_chaos_failover(weights, want):
    """Chaos kills replica 1 mid-stream: every request still completes
    with the reference stream, requeued >= 1, and the dead replica shows
    quarantined (or dead) while replica 0 stays up."""
    _, state = weights
    prompts = PROMPTS[:6]
    chaos.install(chaos.Chaos.parse("replica_kill:replica=1"))
    try:
        router = launch_fleet(ReplicaSpec(CFG, state, num_slots=2), replicas=2, device="cpu",
                              config=RouterConfig(max_restarts=0, quarantine_threshold=2))
        addr = router.start(host="127.0.0.1")
        try:
            streams = drive(ServeClient, addr, router.secret, prompts, 30)
            stats, _ = fleet_status(router, addr)
            fired = chaos.get().fired
        finally:
            router.stop()
    finally:
        chaos.reset()
    assert fired, "chaos rule never fired"
    assert streams == want[30][:6]
    assert stats["routing"]["requeued"] >= 1, stats["routing"]
    states = {r["replica"]: r["state"] for r in stats["replicas"]}
    assert states[1] in ("quarantined", "dead") and states[0] == "up", states


def test_replicas_share_the_serving_weights_and_a_kill_frees_the_engine(weights):
    """Replicas on one device build their engines over one serving state;
    a killed replica's engine is freed with the cyclic collector off."""
    _, state = weights
    fleet = build_replicas(ReplicaSpec(CFG, state, num_slots=2, device="cpu"), 3, "s3cret")
    assert [r.device for r in fleet] == [torch.device("cpu")] * 3
    for r in fleet:
        r.start()
    try:
        engines = [r.server.scheduler.engine for r in fleet]
        for name, t in engines[0].model.state_dict().items():
            assert all(e.model.state_dict()[name].data_ptr() == t.data_ptr() for e in engines[1:]), name
        assert engines[0].model.layers[0].attn.wq.weight.data_ptr() == \
            fleet[0].spec.serving_params(torch.device("cpu"))["layers.0.attn.wq.weight"].data_ptr()
        dead = weakref.ref(engines[1])
        del engines
        gc.disable()
        try:
            fleet[1].kill()
            assert fleet[1].server is None and not fleet[1].alive()
            assert dead() is None, "the killed replica's engine outlived kill() without the collector"
        finally:
            gc.enable()
        fleet[1].respawn()
        assert fleet[1].alive() and fleet[1].restarts == 1
    finally:
        for r in fleet:
            r.stop(drain=False)


def test_replicas_on_one_device_take_turns_under_one_host_lock(weights):
    """Replicas on one device share one host lock, and a replica's loop
    neither admits nor steps while another thread holds it; an engine built
    alone has a lock of its own."""
    from maggy_tpu_torch.serve import Engine

    _, state = weights
    spec = ReplicaSpec(CFG, state, num_slots=2, device="cpu")
    fleet = build_replicas(spec, 2, "s3cret")
    for r in fleet:
        r.start()
    try:
        locks = [r.server.scheduler.engine.host_lock for r in fleet]
        assert locks[0] is locks[1] is spec.host_lock(torch.device("cpu"))
        assert Engine(CFG, state, num_slots=2, device="cpu").host_lock is not locks[0]
        engine = fleet[0].server.scheduler.engine
        with locks[0]:
            rid = fleet[0].client.submit(PROMPTS[0], max_new=MAX_NEW)
            time.sleep(0.3)
            assert engine.steps == 0 and engine.slots.active_count == 0
            assert not fleet[0].client.poll(rid)["tokens"]
        deadline = time.time() + 60
        while not fleet[0].client.poll(rid)["done"]:
            assert time.time() < deadline, "the request never finished once the lock was free"
            time.sleep(0.01)
        assert len(fleet[0].client.poll(rid)["tokens"]) == MAX_NEW
    finally:
        for r in fleet:
            r.stop(drain=False)


def test_what_is_not_ported_raises_and_no_cuda_needs_a_device(weights):
    _, state = weights
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        ReplicaSpec(CFG, state, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        Router([], autopilot=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_fleet(ReplicaSpec(CFG, state), replicas=2)


# ------------------------------------------------- router decisions vs JAX


def fake_replica(index, num_slots=4, state="up", role="any"):
    """A healthy-looking replica for router decisions (no engine/port)."""
    return types.SimpleNamespace(
        index=index,
        state=state,
        spec=types.SimpleNamespace(num_slots=num_slots, role=role),
        describe=lambda: {"replica": index, "state": state, "addr": None,
                          "restarts": 0, "devices": [], "uptime_s": 0.0},
        client=None,
    )


STATS = [
    {"num_slots": 4, "active_slots": 1, "queue_depth": 0, "ttft_ms_p50": 80},
    {"num_slots": 4, "active_slots": 4, "queue_depth": 8, "ttft_ms_p50": 80},
    {"num_slots": 2, "active_slots": 0, "queue_depth": 0},
    {"num_slots": 2, "active_slots": 2, "queue_depth": 0, "ttft_ms_p50": 37.5},
    {"num_slots": 8, "active_slots": 3, "queue_depth": 5},
    {},
]


@pytest.mark.parametrize("stats", STATS)
@pytest.mark.parametrize("prior", [100.0, 123.0])
def test_projected_ttft_equals_jax(stats, prior):
    assert trouter.projected_ttft_ms(dict(stats), prior) == jrouter.projected_ttft_ms(dict(stats), prior)


def admission(mod, slo, mode, stats, pending):
    """A router over one fake replica with ``stats`` cached and ``pending``
    queued entries: the reply type, its projection and the entry's state."""
    router = mod.Router([fake_replica(0, num_slots=2)],
                        config=mod.RouterConfig(slo_ttft_ms=slo, admission=mode))
    router._stats_cache[0] = dict(stats)
    for i in range(pending):
        router._entries[f"p{i}"] = mod.RouteEntry(rid=f"p{i}", payload={"prompt": [1]})
        router._pending.append(f"p{i}")
    router.replicas[0].client = types.SimpleNamespace(submit=lambda **kw: "remote")
    reply = router._on_submit({"prompt": [1, 2, 3]})
    state = None
    if reply["type"] == "SUBMIT":
        state = router._on_poll({"id": reply["id"]})["state"]
        router._dispatch_pending(time.time())  # parked while over the SLO
        state = (state, router._on_poll({"id": reply["id"]})["state"])
    return (reply["type"], reply.get("projected_ttft_ms"), reply.get("retry_after_ms"), state,
            router.counters["shed"])


LOADED = {"num_slots": 2, "active_slots": 2, "queue_depth": 10, "ttft_ms_p50": 100.0}
IDLE = {"num_slots": 2, "active_slots": 0, "queue_depth": 0, "ttft_ms_p50": 20.0}


@pytest.mark.parametrize("slo, mode, stats, pending", [
    (150.0, "shed", LOADED, 0),
    (150.0, "queue", LOADED, 0),
    (150.0, "shed", IDLE, 0),
    (30.0, "shed", IDLE, 3),
    (None, "shed", LOADED, 2),
])
def test_admission_equals_jax(slo, mode, stats, pending):
    port = admission(trouter, slo, mode, stats, pending)
    assert port == admission(jrouter, slo, mode, stats, pending)
    if slo == 150.0 and stats is LOADED:
        assert port[0] == ("BUSY" if mode == "shed" else "SUBMIT")


def requeue_order(mod):
    """Fresh arrivals held by the SLO, then two requeued entries pushed to
    the front: the order they are redispatched in, and what POLL says."""
    router = mod.Router([fake_replica(0, num_slots=2)],
                        config=mod.RouterConfig(slo_ttft_ms=1.0, admission="queue"))
    router._stats_cache[0] = {"num_slots": 2, "active_slots": 2, "queue_depth": 5, "ttft_ms_p50": 100.0}
    fresh = [router._on_submit({"prompt": [1, k]})["id"] for k in (2, 3)]
    for rid, prompt in (("rq1", [3, 4]), ("rq2", [5, 6])):
        entry = mod.RouteEntry(rid=rid, payload={"prompt": prompt})
        entry.state = mod.REQUEUED
        entry.resubmits = 1
        router._entries[rid] = entry
        router._pending.appendleft(rid)
    order = [rid if rid.startswith("rq") else fresh.index(rid) for rid in router._pending]
    polls = [{k: router._on_poll({"id": rid})[k] for k in ("state", "id", "done", "resubmits", "tokens")}
             for rid in ("rq1", "rq2")]
    sent = []
    router.replicas[0].client = types.SimpleNamespace(submit=lambda **kw: sent.append(kw["prompt"]) or "remote")
    router._dispatch_pending(time.time())
    return order, polls, sent, [router._entries[r].state for r in ("rq1", "rq2", *fresh)]


def test_requeue_order_and_poll_requeued_equal_jax():
    port = requeue_order(trouter)
    assert port == requeue_order(jrouter)
    order, polls, sent, states = port
    assert order == ["rq2", "rq1", 0, 1] and polls[0]["state"] == "requeued"
    assert sent == [[5, 6], [3, 4]] and states == ["routed", "routed", "pending", "pending"]


BROWNOUT = [
    # (burning, dt) sequences: sustained burn, flapping, recovery
    [(True, 0.0), (True, 1.0), (True, 3.0), (True, 6.5), (True, 9.6), (True, 20.0)]
    + [(False, 21.0), (False, 25.0), (False, 26.1), (False, 40.0)],
    [(True, 0.0), (False, 2.9), (True, 3.0), (True, 5.9), (True, 6.0), (False, 6.5), (False, 11.6)],
    [(False, 0.0), (False, 100.0), (True, 101.0), (True, 104.0), (True, 104.1)],
]


@pytest.mark.parametrize("seq", BROWNOUT)
@pytest.mark.parametrize("escalate_s, recover_s", [(3.0, 5.0), (0.5, 1.0)])
def test_brownout_ladder_steps_equal_jax(seq, escalate_s, recover_s):
    def run(mod):
        ladder = mod.BrownoutLadder(escalate_s=escalate_s, recover_s=recover_s)
        return [ladder.step(b, t) for b, t in seq], ladder.snapshot()

    assert run(trouter) == run(jrouter)


BREAKER = [
    # (op, args) scripts over one breaker: trip, probation, verdicts
    [("score", (300.0, 50.0, 3.0, 50.0, 0.0)), ("score", (300.0, 50.0, 3.0, 50.0, 1.0)),
     ("ok", (2.0,)), ("ok", (7.0,)), ("take_probe", ("a",)), ("ok", (7.1,)),
     ("observe_ttft", ("b", 10.0, 7.2)), ("observe_ttft", ("a", 140.0, 7.3)), ("ok", (7.4,))],
    [("score", (300.0, 50.0, 3.0, 50.0, 0.0)), ("score", (300.0, 50.0, 3.0, 50.0, 1.0)),
     ("ok", (6.5,)), ("take_probe", ("a",)), ("observe_ttft", ("a", 900.0, 7.0)), ("ok", (8.0,)),
     ("ok", (12.5,)), ("take_probe", ("c",)), ("probe_lost", ("x",)), ("take_probe", ("d",)),
     ("probe_lost", ("c",)), ("take_probe", ("d",))],
    [("score", (40.0, 5.0, 3.0, 50.0, 0.0)), ("score", (None, 5.0, 3.0, 50.0, 1.0)),
     ("score", (60.0, 10.0, 3.0, 50.0, 2.0)), ("score", (20.0, 10.0, 3.0, 50.0, 3.0)),
     ("score", (60.0, 10.0, 3.0, 50.0, 4.0)), ("score", (61.0, 10.0, 3.0, 50.0, 5.0)), ("reset", ())],
    [("begin_probation", (200.0,)), ("ok", (0.0,)), ("take_probe", ("p",)), ("take_probe", ("q",)),
     ("observe_ttft", ("p", 150.0, 1.0)), ("ok", (1.1,))],
]


@pytest.mark.parametrize("script", BREAKER)
def test_circuit_breaker_transitions_equal_jax(script):
    def run(mod):
        b = mod.CircuitBreaker(3, trips=2, cooldown_s=5.0)
        return [(getattr(b, op)(*args), b.state) for op, args in script], b.snapshot()

    assert run(treplica) == run(jreplica)


def test_retry_budget_equals_jax():
    def run(mod):
        budget = mod.RetryBudget(capacity=3, window_s=6.0)
        return [budget.consume(t) for t in (0.0, 0.1, 0.2, 0.3, 0.4, 2.5, 2.6, 10.0, 10.0, 10.0, 10.0)]

    assert run(treplica) == run(jreplica)


def test_chaos_replica_kill_fires_once_on_its_replica():
    def run(mod):
        ch = mod.Chaos.parse("replica_kill:replica=1")
        return [ch.replica_kill(i) for i in (0, 1, 1, 2)]

    assert run(chaos) == run(jchaos) == [False, True, False, False]
