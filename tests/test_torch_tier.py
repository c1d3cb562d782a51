"""The port's host-DRAM KV tier: the host pool, prefix map and tiering
policy units of ``tests/test_tier.py`` run against both packages, then the
engine's spill -> swap-in byte parity, the stale resume pack and the env
gate on the port (float32 ``DecoderConfig.tiny`` with weights converted from
the JAX init)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import transformer as jt
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu.resilience import chaos as jchaos
from maggy_tpu.serve import Engine as JEngine
from maggy_tpu.serve import Request as JRequest
from maggy_tpu.serve import SamplingParams as JSamplingParams
from maggy_tpu.serve.paging import BlockAllocator as JBlockAllocator
from maggy_tpu.serve.tier import FleetPrefixMap as JFleetPrefixMap
from maggy_tpu.serve.tier import HostPagePool as JHostPagePool
from maggy_tpu.serve.tier import TieringPolicy as JTieringPolicy
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.resilience import chaos as tchaos
from maggy_tpu_torch.serve import Engine, Request, SamplingParams
from maggy_tpu_torch.serve.paging import BlockAllocator
from maggy_tpu_torch.serve.tier import FleetPrefixMap, HostPagePool, TieringPolicy

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CFG = tt.DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)

PACKAGES = {
    "jax": dict(pool=JHostPagePool, prefixmap=JFleetPrefixMap, policy=JTieringPolicy,
                allocator=JBlockAllocator, chaos=jchaos),
    "torch": dict(pool=HostPagePool, prefixmap=FleetPrefixMap, policy=TieringPolicy,
                  allocator=BlockAllocator, chaos=tchaos),
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def weights():
    params = unbox(jt.Decoder(JCFG).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"])
    return params, decoder_params_from_flax(jax.device_get(params), CFG)


def _blocks(n, fill, leaves=("k", "v")):
    return {ks: np.full((n, 2, 3), fill, np.float32) for ks in leaves}


# ----------------------------------------------------------------- host pool


def test_host_pool_roundtrip_and_lru_eviction(pkg):
    pool = pkg["pool"](capacity_pages=4)
    assert pool.put("a", _blocks(2, 1.0), {"kind": "resume"})
    assert pool.put("b", _blocks(2, 2.0), {"kind": "prefix"})
    # roundtrip is byte-exact and returns copies
    blocks, meta = pool.get("a")
    np.testing.assert_array_equal(blocks["k"], np.full((2, 2, 3), 1.0))
    assert meta == {"kind": "resume"}
    blocks["k"][:] = 99.0  # a caller scribbling on its copy
    np.testing.assert_array_equal(pool.get("a")[0]["k"], np.full((2, 2, 3), 1.0))
    # the get refreshed "a": a put that needs room evicts "b" (LRU), not "a"
    assert pool.put("c", _blocks(2, 3.0), {})
    assert pool.has("a") and pool.has("c") and not pool.has("b")
    st = pool.stats()
    assert st["resident_packs"] == 2 and st["host_evictions"] == 1
    assert st["host_pages_used"] == 4 and st["host_pages_free"] == 0
    assert pool.get("b") is None and pool.stats()["misses"] == 1
    assert sorted(pool.keys()) == ["a", "c"]


def test_host_pool_refuses_oversized_and_shrinks(pkg):
    pool = pkg["pool"](capacity_pages=3)
    assert not pool.put("big", _blocks(4, 1.0), {})  # > whole budget
    assert pool.put("a", _blocks(2, 1.0), {})
    assert pool.put("b", _blocks(1, 2.0), {})
    # same-key put replaces (old pages recycled, no eviction needed)
    assert pool.put("a", _blocks(2, 5.0), {})
    assert pool.has("b")
    np.testing.assert_array_equal(pool.get("a")[0]["v"], np.full((2, 2, 3), 5.0))
    # shrink evicts immediately, LRU first ("b" is older now)
    pool.set_capacity(2)
    assert pool.has("a") and not pool.has("b")
    pool.set_capacity(0)
    assert pool.stats()["resident_packs"] == 0
    pool.drop("a")  # drop on a missing key is a no-op


def test_host_pool_keeps_bf16_bits_and_scattered_pages():
    """bf16 has no numpy dtype: the port's pool holds torch tensors, and a
    pack whose pages are scattered over recycled ids reads back bit for
    bit. Its buffers grow geometrically, not to each put's high-water."""
    pool = HostPagePool(capacity_pages=64)
    gen = torch.Generator().manual_seed(0)
    packs = {f"p{i}": torch.randn((3 + i, 2, 4, 2, 8), generator=gen).to(torch.bfloat16) for i in range(4)}
    for key, t in packs.items():
        assert pool.put(key, {"k": t, "v": -t}, {})
    # 3 rows, then max(7, 2 * 3), 14, 28: each growth at least doubles
    assert pool._buffers["k"].shape[0] == 28
    pool.drop("p0")
    pool.drop("p2")
    big = torch.randn((8, 2, 4, 2, 8), generator=gen).to(torch.bfloat16)
    assert pool.put("mixed", {"k": big, "v": big}, {})  # reuses both holes
    for key, t in {**packs, "mixed": big}.items():
        if not pool.has(key):
            continue
        got, _ = pool.get(key)
        assert got["k"].dtype == torch.bfloat16
        assert torch.equal(got["k"].view(torch.int16), t.view(torch.int16))


def test_chaos_host_pool_slow_delays_fill(pkg):
    chaos = pkg["chaos"]
    pool = pkg["pool"](capacity_pages=2)
    pool.put("a", _blocks(1, 1.0), {})
    chaos.install(chaos.Chaos.parse("host_pool_slow:ms=80,times=1"))
    try:
        t0 = time.perf_counter()
        assert pool.get("a") is not None
        slow = time.perf_counter() - t0
        assert slow >= 0.08, f"chaos delay not injected ({slow * 1e3:.1f}ms)"
        t0 = time.perf_counter()
        assert pool.get("a") is not None  # budget spent: back to fast
        assert time.perf_counter() - t0 < 0.08
    finally:
        chaos.reset()


# ------------------------------------------------- prefix map, policy, ranking


def test_prefix_map_update_replaces_and_forgets(pkg):
    m = pkg["prefixmap"]()
    m.update(0, ["d1", "d2"])
    m.update(1, ["d2"])
    assert m.replicas_for("d1") == frozenset({0})
    assert m.replicas_for("d2") == frozenset({0, 1})
    m.update(0, ["d3"])  # a fresh snapshot REPLACES the replica's contribution
    assert m.replicas_for("d1") == frozenset()
    assert m.replicas_for("d2") == frozenset({1})
    m.forget_replica(1)
    assert m.replicas_for("d2") == frozenset()
    snap = m.snapshot()
    assert snap["entries"] == 1 and snap["replicas"] == {"0": 1}


def test_prefix_map_bounded_lru(pkg):
    m = pkg["prefixmap"](max_entries=2)
    m.update(0, ["a"])
    m.update(1, ["b"])
    m.update(2, ["c"])  # trims "a", the least recently reported
    assert m.replicas_for("a") == frozenset()
    assert m.replicas_for("b") == frozenset({1})
    assert m.replicas_for("c") == frozenset({2})
    assert m.snapshot()["entries"] == 2


def test_tiering_policy_verdict_and_ledger(pkg):
    pol = pkg["policy"](low_water_pct=0.1)
    assert not pol.should_spill(None)  # no ledger yet -> never spill
    assert not pol.should_spill(0.1)  # at the mark is still fine
    assert pol.should_spill(0.09)
    pol.note_spill(3, pressure=True)
    pol.note_spill(2, prefix=True)
    pol.note_fill(2, prefix=True)
    st = pol.stats()
    assert st["spills"] == 2 and st["spilled_pages"] == 5
    assert st["prefix_spills"] == 1 and st["pressure_spills"] == 1
    assert st["fills"] == 1 and st["prefix_fills"] == 1


def test_allocator_coldest_and_fragmentation_exclude_shared(pkg):
    alloc = pkg["allocator"](num_pages=8, page_size=16)
    mine = alloc.alloc(3)
    theirs = alloc.alloc(2)
    alloc.share(theirs)  # aliased by a second request now
    alloc.touch(mine, gen=5)
    assert set(alloc.coldest()) == set(mine), "shared pages leaked into spill ranking"
    assert set(alloc.coldest(include_shared=True)) == set(mine) | set(theirs)
    frag = alloc.fragmentation()
    assert frag["pages_pinned_shared"] == 2 and frag["pages_reclaimable"] == 3
    alloc.check_invariants()
    alloc.release(theirs)  # one sharer lets go
    frag = alloc.fragmentation()
    assert frag["pages_pinned_shared"] == 0 and frag["pages_reclaimable"] == 5
    assert set(alloc.coldest()) == set(mine) | set(theirs)
    alloc.check_invariants()


# ------------------------------------------------- engine spill / swap-in


def _drive(eng, slot, toks, n):
    while len(toks) < n:
        out = eng.step()
        if slot in out.tokens:
            toks.append(out.tokens[slot])
        if not eng.slots.active_slots():
            break
    return toks


def _engine(sd, **kw):
    return Engine(CFG, sd, **{"num_slots": 2, "num_pages": 24, "device": "cpu", **kw})


def _free_run(eng, prompt, sp, rid="a"):
    slot, first = eng.admit(Request(id=rid, prompt=list(prompt), params=sp))
    toks = _drive(eng, slot, [first], sp.max_new)[: sp.max_new]
    eng.release(slot)
    eng.flush()
    return toks


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_spill_swap_in_byte_parity(weights, temperature):
    """A stream preempted through spill_stream and re-admitted from its host
    pack continues byte-identically with an uninterrupted run — sampled
    (seeded) and greedy — and a later same-prefix admission fills from the
    released prefix pack at suffix-only cost. The greedy stream equals the
    JAX engine's."""
    params, sd = weights
    prompt = list(range(3, 40))  # 37 tokens, spans >2 pages
    sp = SamplingParams(max_new=10, temperature=temperature, seed=5)
    free_eng = _engine(sd, tier=False)
    assert free_eng.tier is None
    free = _free_run(free_eng, prompt, sp)

    eng = _engine(sd, tier=True)
    r = Request(id="a", prompt=list(prompt), params=sp)
    slot, first = eng.admit(r)
    # the scheduler owns the drained-token history
    r.tokens.append(first)
    for _ in range(4):
        out = eng.step()
        if slot in out.tokens:
            r.tokens.append(out.tokens[slot])
    out = eng.flush()
    if slot in out.tokens:
        r.tokens.append(out.tokens[slot])
    toks = list(r.tokens)
    # preempt with spill: the scheduler's order — capture, then release
    assert eng.spill_stream(slot)
    eng.release(slot)
    resumed = Request(id="a", prompt=list(prompt), params=sp, tokens=list(toks))
    slot2, first2 = eng.admit(resumed)
    toks2 = _drive(eng, slot2, list(toks) + [first2], sp.max_new)
    assert toks2[: sp.max_new] == free, "swap-in diverged from the free run"
    ts = eng.tier_stats
    assert ts["fills"] == 1 and ts["prefix_fills"] == 0, ts
    assert eng.prefill_tokens < 2 * len(prompt)  # only the undrained suffix ran
    if temperature == 0.0:
        jeng = JEngine(JCFG, params, num_slots=2, num_pages=24, tier=False)
        jr = JRequest(id="a", prompt=list(prompt), params=JSamplingParams(max_new=10, seed=5))
        jslot, jfirst = jeng.admit(jr)
        assert _drive(jeng, jslot, [jfirst], 10)[:10] == free

    # release leaves a prefix pack; a same-prefix admission fills from it
    eng.release(slot2)
    assert eng.tier_stats["prefix_spills"] >= 1
    pt = eng.prefill_tokens
    probe = dict(prompt=list(prompt) + [41, 42], params=SamplingParams(max_new=3, temperature=0.0, seed=9))
    slot3, f3 = eng.admit(Request(id="c", **probe))
    assert eng.tier_stats["prefix_fills"] == 1
    assert eng.prefill_tokens - pt < len(prompt)
    _, f4 = free_eng.admit(Request(id="c", **probe))
    assert int(f3) == int(f4)


def test_stale_resume_pack_dropped(weights):
    """A resume pack whose drained-token history no longer matches the
    re-admitted request is dropped, not served."""
    _, sd = weights
    prompt = list(range(3, 30))
    sp = SamplingParams(max_new=6, temperature=0.0, seed=1)
    eng = _engine(sd, tier=True)
    r = Request(id="a", prompt=list(prompt), params=sp)
    slot, first = eng.admit(r)
    r.tokens.append(first)
    for _ in range(2):
        out = eng.step()
        if slot in out.tokens:
            r.tokens.append(out.tokens[slot])
    eng.flush()
    assert eng.spill_stream(slot)
    eng.release(slot)
    # a history the pack did not capture (in-vocab: the port's embedding
    # raises on an out-of-range id where JAX's gather clamps)
    other = [(t + 1) % CFG.vocab_size for t in r.tokens[:2]]
    resumed = Request(id="a", prompt=list(prompt), params=sp, tokens=other)
    eng.admit(resumed)
    assert not eng.tier.has(f"rid:{resumed.id}"), "stale pack must be dropped"
    ts = eng.tier_stats
    assert ts["fills"] == ts["prefix_fills"], ts  # never the stale pack


def test_tier_env_gate_and_knob_seams(weights, monkeypatch):
    _, sd = weights
    monkeypatch.setenv("MAGGY_TPU_SERVE_TIER", "0")
    eng = _engine(sd)
    assert eng.tier is None and eng.tier_stats == {"enabled": False}
    monkeypatch.delenv("MAGGY_TPU_SERVE_TIER")
    eng = _engine(sd)
    assert eng.tier is not None and not eng.tier.pin_memory
    assert eng.tier_stats["host_pages_total"] == 2 * eng.num_pages
    monkeypatch.setenv("MAGGY_TPU_SERVE_TIER_PAGES", "5")
    assert _engine(sd).tier_stats["host_pages_total"] == 5
    eng.set_tier_host_pages(7)
    assert eng.tier_stats["host_pages_total"] == 7
    eng.set_tier_low_water(0.2)
    assert eng.tier_policy.low_water_pct == 0.2
    # dense engines never attach a tier
    assert _engine(sd, paged=False).tier is None
