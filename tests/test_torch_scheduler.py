"""The port's QoS-aware Scheduler against the JAX package's.

The same scripted submission set (greedy, mixed QoS classes and tenants,
queued before the loop starts) goes through JAX's ``Scheduler`` and the
port's: the token streams and the admission order by request (read from the
``req.admitted`` events) must be equal. Then the port counterparts of the
scheduler cases of ``tests/test_serve_engine.py`` and of
``tests/test_overload_qos.py``'s priority-preemption byte parity and quota
starvation. Float32 ``DecoderConfig.tiny`` with weights converted from the
JAX init; every wait has its own timeout.
"""

import time

import jax
import jax.numpy as jnp
import pytest
import torch

from maggy_tpu import serve as jserve
from maggy_tpu import telemetry as jtelemetry
from maggy_tpu.models import transformer as jt
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch import serve as tserve
from maggy_tpu_torch import telemetry
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.exceptions import BadArgumentsError
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.models.generate import generate_cached
from maggy_tpu_torch.serve import Engine, Request, SamplingParams, Scheduler
from maggy_tpu_torch.serve.qos import BEST_EFFORT, PREMIUM, STANDARD

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CFG = tt.DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)
TERMINAL = ("done", "failed", "cancelled", "expired")

# the scripted set: (prompt, max_new, qos, tenant), queued before start
SCRIPT = [
    ([1, 2, 3, 4], 4, BEST_EFFORT, "bulk"),
    ([5, 6, 7], 5, STANDARD, "acme"),
    ([9, 10, 11, 12, 13], 3, PREMIUM, "acme"),
    ([2, 4, 6, 8, 10, 12], 6, BEST_EFFORT, "bulk"),
    ([7, 3], 4, PREMIUM, "bulk"),
    ([40, 41, 42], 5, STANDARD, "acme"),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9], 3, BEST_EFFORT, "acme"),
    ([11, 12], 4, STANDARD, "bulk"),
]


@pytest.fixture(scope="module")
def weights():
    params = unbox(jt.Decoder(JCFG).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"])
    return params, decoder_params_from_flax(jax.device_get(params), CFG)


def run_all(requests, timeout=90):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(r.state in TERMINAL for r in requests):
            return
        time.sleep(0.01)
    raise AssertionError(f"requests stuck: {[(r.id, r.state) for r in requests]}")


def run_script(serve, engine, tel):
    """Queue SCRIPT before the loop starts, run it, and return the streams
    and the admission order (indices into SCRIPT)."""
    sched = serve.Scheduler(engine, telemetry_recorder=tel, qos_window_s=3600.0)
    reqs = [sched.submit(p, serve.SamplingParams(max_new=n), qos=q, tenant=t) for p, n, q, t in SCRIPT]
    index = {r.id: i for i, r in enumerate(reqs)}
    sched.start()
    try:
        run_all(reqs)
    finally:
        sched.stop()
    assert all(r.state == "done" for r in reqs), [(r.state, r.error) for r in reqs]
    order = [index[e["attrs"]["rid"]] for e in tel.drain_events()
             if e["name"] in ("req.admitted", "req.prefix_admitted")]
    return [list(r.tokens) for r in reqs], order


@pytest.fixture(scope="module")
def jax_run(weights):
    params, _ = weights
    return run_script(jserve, jserve.Engine(JCFG, params, num_slots=2), jtelemetry.Telemetry(worker="jax"))


@pytest.fixture(scope="module")
def port_run(weights):
    _, sd = weights
    return run_script(tserve, Engine(CFG, sd, num_slots=2, device="cpu"), telemetry.Telemetry(worker="port"))


def test_scheduler_streams_equal_jax(jax_run, port_run):
    assert port_run[0] == jax_run[0]


def test_admission_order_equals_jax(jax_run, port_run):
    order = port_run[1]
    assert sorted(order) == list(range(len(SCRIPT)))
    # premium first, then standard, then best-effort, FIFO within a class
    assert order[:2] == [2, 4]
    assert order == jax_run[1]


# --------------------------------------------- tests/test_serve_engine.py


def engine(sd, num_slots=4, **kw):
    return Engine(CFG, sd, num_slots=num_slots, device="cpu", **kw)


def reference(sd, prompt, max_new):
    """One-shot greedy ``generate_cached`` of the port (held to JAX's by
    tests/test_torch_generate.py)."""
    model = tt.Decoder(CFG, device="cpu")
    model.load_state_dict(sd)
    buf = torch.zeros((1, len(prompt) + max_new), dtype=torch.int32)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    out = generate_cached(model, buf, torch.tensor([len(prompt)]))
    return [int(t) for t in out[0, len(prompt):]]


def test_greedy_scheduler_matches_one_shot(weights):
    _, sd = weights
    sched = Scheduler(engine(sd))
    prompts = [[1, 2, 3, 4], [5, 6, 7], [9, 10, 11, 12, 13], [2, 4, 6, 8, 10, 12], [7, 3], [40, 41, 42]]
    sched.start()
    try:
        reqs = [sched.submit(p, SamplingParams(max_new=6)) for p in prompts]
        run_all(reqs)
    finally:
        sched.stop()
    for req, prompt in zip(reqs, prompts):
        assert req.state == "done", (req.state, req.error)
        assert req.tokens == reference(sd, prompt, 6), prompt


def test_eos_stops_early(weights):
    _, sd = weights
    eos = reference(sd, [1, 2, 3], 6)[1]
    sched = Scheduler(engine(sd))
    sched.start()
    try:
        req = sched.submit([1, 2, 3], SamplingParams(max_new=6, eos_id=eos))
        run_all([req])
    finally:
        sched.stop()
    assert req.state == "done"
    assert req.tokens[-1] == eos and len(req.tokens) == 2


def test_decode_step_one_shape_under_churn(weights):
    """Request churn never adds a decode shape (the RecompileSentinel's
    steady program); prefill runs at the buckets 8 and 16 only."""
    _, sd = weights
    eng = engine(sd, num_slots=3)
    sched = Scheduler(eng)
    sched.start()
    try:
        reqs = []
        for i in range(9):
            plen = 2 + (i * 3) % 11
            reqs.append(sched.submit(list(range(1, plen + 1)), SamplingParams(max_new=3 + (i % 4))))
            time.sleep(0.02)  # staggered arrivals -> admissions mid-decode
        run_all(reqs)
        sched._metrics_tick(time.time())
        assert sched.sentinel.firing() == []
    finally:
        sched.stop()
    assert all(r.state == "done" for r in reqs)
    counts = eng.compile_counts
    assert counts["decode"] == 1 and counts["admit"] == 1, counts
    assert counts["prefill"] <= 2 and counts["prefix_admit"] <= 2, counts


def test_submit_validates_length_and_params(weights):
    _, sd = weights
    sched = Scheduler(engine(sd))
    with pytest.raises(BadArgumentsError, match="max_seq_len"):
        sched.submit(list(range(60)), SamplingParams(max_new=10))
    with pytest.raises(BadArgumentsError, match="empty prompt"):
        sched.submit([], SamplingParams())
    with pytest.raises(ValueError, match="max_new"):
        sched.submit([1], SamplingParams(max_new=0))
    with pytest.raises(BadArgumentsError, match="qos"):
        sched.submit([1], SamplingParams(), qos="gold")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        Scheduler(engine(sd), autopilot=True)


def test_cancel_storm_releases_all_resources(weights):
    """Cancel and deadline expiry release cache resources through the one
    release path: after the storm no slot and no page leaks, the tier's
    spills leave nothing referenced, and the engine still serves."""
    _, sd = weights
    eng = engine(sd, num_slots=3)
    sched = Scheduler(eng)
    sched.start()
    try:
        reqs = [sched.submit([1 + i, 2, 3], SamplingParams(max_new=30), deadline_s=0.2 if i % 4 == 3 else None)
                for i in range(12)]
        time.sleep(0.15)  # let some admit and decode
        for i, r in enumerate(reqs):
            if i % 4 != 3:
                sched.cancel(r.id)
        run_all(reqs, timeout=60)
        assert not any(r.state == "failed" for r in reqs), [(r.state, r.error) for r in reqs]
        assert sched.drain(timeout=30)
    finally:
        sched.stop()
    assert eng.slots.active_count == 0
    eng.slots.check_invariants()
    assert eng.allocator.pages_free == eng.allocator.pages_total, eng.allocator.stats()
    eng.allocator.check_invariants()
    eng.page_table.check_invariants(eng.allocator)
    slot, first = eng.admit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new=4)))
    toks = [first]
    while len(toks) < 4:
        toks.extend(eng.step().tokens.values())
    assert toks == reference(sd, [1, 2, 3], 4)


def test_stats_surfaces(weights):
    _, sd = weights
    sched = Scheduler(engine(sd, num_slots=2), slo_ttft_ms=1e6)
    sched.start()
    try:
        reqs = [sched.submit([3, 4, 5 + i], SamplingParams(max_new=3), tenant="t") for i in range(3)]
        run_all(reqs)
    finally:
        sched.stop()
    s = sched.stats()
    assert s["requests_done"] == 3 and s["requests_failed"] == 0 and s["slo_ok"] == 3
    assert s["ttft_ms_p50"] is not None and s["tpot_ms_p50"] is not None
    assert set(s["latency"]) == {"ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms"}
    assert s["tier"]["enabled"] and s["profcap"]["captures"] == 0
    assert sum(c["admitted"] for c in s["qos"]["counters"].values()) == 3 and s["alerts"] == []


# --------------------------------------------- tests/test_overload_qos.py


def _finish(reqs, timeout=90):
    run_all(reqs, timeout)
    assert all(r.state == "done" for r in reqs), [(r.state, r.error) for r in reqs]
    return [list(r.tokens) for r in reqs]


def test_priority_preemption_byte_parity(weights):
    """Page pressure preempts the LOWEST class first, and a premium arrival
    never loses its pages to best-effort growth — while every stream stays
    byte-identical to an unpressured run (spilled to the host tier and
    swapped back in)."""
    _, sd = weights
    jobs = [(list(range(1 + i, 15 + i)), SamplingParams(max_new=12, temperature=0.7, seed=i)) for i in range(3)]
    tel = telemetry.Telemetry(worker="qos-preempt-test")
    eng = engine(sd, num_slots=3, paged=True, num_pages=6, telemetry_recorder=tel)
    sched = Scheduler(eng)
    sched.start()
    try:
        reqs = [sched.submit(p, sp, tenant="bulk", qos=BEST_EFFORT) for p, sp in jobs[:2]]
        reqs.append(sched.submit(jobs[2][0], jobs[2][1], tenant="acme", qos=PREMIUM))
        streams = _finish(reqs)
        preemptions = sched.preemptions
        counters = {c: dict(v) for c, v in sched.qos_counters.items()}
    finally:
        sched.stop()
    assert preemptions >= 1, "pressure did not preempt"
    assert counters[BEST_EFFORT]["preempted"] == preemptions
    assert counters[PREMIUM]["preempted"] == 0
    assert eng.tier_stats["spills"] - eng.tier_stats["prefix_spills"] == preemptions
    assert eng.tier_stats["fills"] >= 1
    sched2 = Scheduler(engine(sd, num_slots=3, paged=True, num_pages=12))
    sched2.start()
    try:
        free = _finish([sched2.submit(p, sp) for p, sp in jobs])
    finally:
        sched2.stop()
    assert streams == free, "priority preemption changed token streams"
    snap = tel.snapshot()
    assert snap["counters"].get(f"serve.qos.preempted.{BEST_EFFORT}") == preemptions
    names = [e["name"] for e in tel.drain_events()]
    assert "req.preempted_for_priority" in names


def test_quota_starvation_regression(weights):
    """A best-effort flood cannot park a premium arrival: priority
    admission pops it past the whole flood as soon as a slot frees."""
    _, sd = weights
    sched = Scheduler(engine(sd, num_slots=1))
    sched.start()
    try:
        flood = [sched.submit([10 + i, 11, 12], SamplingParams(max_new=6), tenant="bulk") for i in range(10)]
        premium = sched.submit([1, 2, 3], SamplingParams(max_new=6), tenant="acme", qos=PREMIUM)
        _finish(flood + [premium], timeout=120)
        later = [r for r in flood if r.admitted_ts is not None and r.admitted_ts > premium.admitted_ts]
        assert len(later) >= 5, f"premium only outran {len(later)} of 10 best-effort arrivals"
        assert sched.stats()["qos"]["counters"][PREMIUM]["admitted"] == 1
    finally:
        sched.stop()


def test_prefilled_handoff_through_the_scheduler(weights):
    """``Request.prefilled``: a pack from ``prefill_only`` admitted by the
    scheduler's ``admit_from_kv`` gives the stream a plain submit gives."""
    _, sd = weights
    eng = engine(sd, num_slots=2, prefix_reuse=False)  # both sides run full prefills
    prompts = [[1, 2, 3, 4], [9, 10, 11, 12, 13], list(range(20, 40))]
    params = [SamplingParams(max_new=5, temperature=0.7 * (i % 2), seed=i) for i in range(3)]
    packs = [eng.prefill_only(p, sp) for p, sp in zip(prompts, params)]
    sched = Scheduler(eng)
    sched.start()
    try:
        handed = _finish([sched.submit_prefilled(p, sp, pack) for p, sp, pack in zip(prompts, params, packs)])
        plain = _finish([sched.submit(p, sp) for p, sp in zip(prompts, params)])
    finally:
        sched.stop()
    assert handed == plain
    assert sched.stats()["requests_failed"] == 0
