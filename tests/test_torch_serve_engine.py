"""The port's serving Engine: greedy parity with the JAX Engine, and the
engine's own contracts.

Both engines are driven by the same loop (admit while a slot is free, step,
release a request once it has ``max_new`` tokens), which admits requests as
slots free — staggered against the decode steps. Greedy streams must equal
the JAX engine's token for token: float32 ``DecoderConfig.tiny`` with weights
converted from the JAX init, so one-pass prefill and token-by-token cache
fill agree on every argmax (as ``tests/test_serve_engine.py`` does on the JAX
side). Within the port, streams are compared bit for bit: async == sync,
paged == dense, a sampled stream across slots and batch-mates, and the
prefill handoff (``prefill_only`` -> ``admit_from_kv``) against ``admit``. Then the
host-side units (allocator, page table, slots, prefix index), ported from
``tests/test_paged_kv.py`` and ``tests/test_prefix_reuse.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu import serve as jserve
from maggy_tpu.models import transformer as jt
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.exceptions import BadArgumentsError
from maggy_tpu_torch import serve as tserve
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.serve import (
    BlockAllocator,
    Engine,
    OutOfPagesError,
    PageTable,
    PrefixIndex,
    Request,
    SamplingParams,
    SlotManager,
)
from maggy_tpu_torch.serve.slots import SlotOccupiedError

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CFG = tt.DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)
PAGE = 16  # engine default page size; 4 pages per max_seq_len row here
SYS = list(range(100, 133))  # 33-token system prompt: 2 full pages and 1 token shared
PROMPTS = [SYS + [1, 2, 3], [5, 6, 7], SYS + [9, 10], [2, 4, 6, 8, 10, 12], SYS + [7], [40, 41, 42],
           list(range(1, 20))]
MODES = {
    "paged_async": dict(paged=True, async_decode=True),
    "paged_sync": dict(paged=True, async_decode=False),
    "dense_async": dict(paged=False, async_decode=True),
    "dense_sync": dict(paged=False, async_decode=False),
}


@pytest.fixture(scope="module")
def weights():
    params = unbox(jt.Decoder(JCFG).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"])
    return params, decoder_params_from_flax(jax.device_get(params), CFG)


def jobs(serve, temperature=0.0):
    return [(p, serve.SamplingParams(max_new=4 + i % 3, temperature=temperature, top_k=8 * (i % 2),
                                     seed=11 + i)) for i, p in enumerate(PROMPTS)]


def drive(serve, engine, todo, handoff=False):
    """Admit while a slot is free, step, release finished requests; returns
    the token streams in submission order. ``handoff`` admits each request
    through ``prefill_only`` -> ``admit_from_kv`` instead of ``admit``."""
    pending = list(enumerate(todo))
    streams, owner = {}, {}
    while pending or engine.slots.active_count:
        while pending and engine.slots.free_slots():
            i, (prompt, sp) = pending.pop(0)
            req = serve.Request(prompt=prompt, params=sp)
            if handoff:
                slot, first = engine.admit_from_kv(req, engine.prefill_only(prompt, sp))
            else:
                slot, first = engine.admit(req)
            streams[i], owner[slot] = [first], i
        for slot, tok in engine.step().tokens.items():
            i = owner[slot]
            streams[i].append(tok)
            if len(streams[i]) >= todo[i][1].max_new:
                engine.release(slot)
        engine.slots.check_invariants()
    engine.flush()
    return [streams[i] for i in range(len(todo))]


def port_engine(sd, **kw):
    return Engine(CFG, sd, **{"num_slots": 3, "device": "cpu", **kw})


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy streams, paged-async and dense-sync (its own
    tests hold its four modes equal), with its prefix hits."""
    params, _ = weights
    out = {}
    for name in ("paged_async", "dense_sync"):
        engine = jserve.Engine(JCFG, params, num_slots=3, **MODES[name])
        out[name] = drive(jserve, engine, jobs(jserve)), engine.prefix_hits
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_streams_equal_jax(weights, jax_streams, mode):
    _, sd = weights
    engine = port_engine(sd, **MODES[mode])
    got = drive(tserve, engine, jobs(tserve))
    want, jax_hits = jax_streams["paged_async" if MODES[mode]["paged"] else "dense_sync"]
    assert got == want
    assert engine.prefix_hits == jax_hits > 0
    assert engine.compile_counts["decode"] == 1
    if engine.paged:  # every page returned once the wave drained
        assert engine.allocator.pages_free == engine.allocator.pages_total


def test_sampled_streams_equal_across_modes(weights):
    """Sampled (temperature 0.8, top-k on half the requests) streams are the
    same bytes paged or dense, async or sync, with prefix reuse on or off."""
    _, sd = weights
    runs = {name: drive(tserve, port_engine(sd, **kw), jobs(tserve, 0.8)) for name, kw in MODES.items()}
    runs["no_prefix"] = drive(tserve, port_engine(sd, prefix_reuse=False), jobs(tserve, 0.8))
    first = runs["paged_async"]
    assert all(streams == first for streams in runs.values())
    greedy = drive(tserve, port_engine(sd), jobs(tserve))
    assert greedy != first


def test_sampling_is_seed_deterministic_and_slot_independent(weights):
    """A request's sampled stream is a function of (prompt, params, seed):
    not of its slot or batch-mates."""
    _, sd = weights
    engine = port_engine(sd)
    sp = SamplingParams(max_new=8, temperature=1.0, top_k=8, seed=123)
    alone = drive(tserve, engine, [([9, 9, 9], sp)])[0]
    noise = [([3 + i, 5], SamplingParams(max_new=10, temperature=0.7, seed=i)) for i in range(2)]
    crowded = drive(tserve, engine, noise + [([9, 9, 9], sp), ([9, 9, 9], SamplingParams(
        max_new=8, temperature=1.0, top_k=8, seed=124))])
    assert crowded[2] == alone, "slot/batch neighbours changed sampled output"
    assert crowded[3] != alone, "different seeds produced identical samples"


def test_async_flush_discards_post_finish_garbage(weights):
    """The one extra step a slot decodes before the host learns it finished
    is discarded at drain; flush() retires it; re-admission into the slot
    starts clean."""
    _, sd = weights
    engine = port_engine(sd, num_slots=1, async_decode=True)
    slot, first = engine.admit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new=4)))
    toks = [first]
    assert engine.step().tokens == {}  # output lags dispatch by one step
    while len(toks) < 4:
        toks.extend(engine.step().tokens.values())
    engine.release(slot)
    assert engine.flush().tokens == {}  # the pending token belongs to no one
    assert engine.flush().tokens == {}
    engine.slots.check_invariants()
    slot2, first2 = engine.admit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new=4)))
    toks2 = [first2]
    while len(toks2) < 4:
        toks2.extend(engine.step().tokens.values())
    engine.release(slot2)
    engine.flush()
    sync = drive(tserve, port_engine(sd, async_decode=False), [([1, 2, 3], SamplingParams(max_new=4))])[0]
    assert toks2 == toks == sync
    assert engine.last_drain_ms >= 0.0


def test_decode_keeps_one_shape_under_churn(weights):
    """Churn (prompt lengths 2..12, admissions between steps) never changes
    the decode step's shape; prefill runs at the 8 and 16 buckets only."""
    _, sd = weights
    engine = port_engine(sd)
    todo = [(list(range(1, 3 + (i * 3) % 11)), SamplingParams(max_new=3 + i % 4)) for i in range(9)]
    drive(tserve, engine, todo)
    counts = engine.compile_counts
    assert counts["decode"] == 1 and counts["admit"] == 1, counts
    assert counts["prefill"] <= 2 and counts["prefix_admit"] <= 2, counts


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_preempt_and_resume_is_byte_identical(weights, paged):
    """A sampled request preempted after 5 tokens and re-admitted with them
    (prompt + tokens prefilled, the sampler resuming at gen0 = 5) finishes
    with exactly the stream it would have produced uninterrupted."""
    _, sd = weights
    sp = SamplingParams(max_new=12, temperature=0.9, top_k=16, seed=7)
    prompt = SYS + [4, 5]
    whole = drive(tserve, port_engine(sd, paged=paged), [(prompt, sp)])[0]
    engine = port_engine(sd, paged=paged)
    req = Request(prompt=prompt, params=sp)
    slot, first = engine.admit(req)
    req.tokens.append(first)
    while len(req.tokens) < 5:
        for _, tok in engine.step().tokens.items():
            req.tokens.append(tok)
    engine.release(slot)  # preempt: the pending async token is discarded
    engine.flush()
    req.tokens = req.tokens[:5]
    slot, first = engine.admit(req)
    req.tokens.append(first)
    while len(req.tokens) < sp.max_new:
        req.tokens.extend(engine.step().tokens.values())
    engine.release(slot)
    assert req.tokens[: sp.max_new] == whole


def test_out_of_pages_is_backpressure(weights):
    """A pool of 5 pages (4 usable): admission that cannot get its pages
    raises OutOfPagesError and leaks nothing; decode growth that cannot get
    a page is reported by prepare_step and refused by step."""
    _, sd = weights
    engine = port_engine(sd, num_slots=2, num_pages=5)
    a = Request(prompt=list(range(1, 21)), params=SamplingParams(max_new=30))  # 2 pages, grows to 4
    slot_a, _ = engine.admit(a)
    assert engine.allocator.pages_free == 2
    with pytest.raises(OutOfPagesError):
        engine.admit(Request(prompt=list(range(50, 90)), params=SamplingParams(max_new=4)))  # 3 pages
    assert engine.allocator.pages_free == 2 and engine.slots.active_count == 1
    engine.allocator.check_invariants()
    engine.page_table.check_invariants(engine.allocator)
    slot_b, _ = engine.admit(Request(prompt=list(range(60, 90)), params=SamplingParams(max_new=20)))  # 2 pages
    steps = 0
    while not engine.prepare_step():  # b crosses into its third page first
        engine.step()
        steps += 1
    assert steps > 0 and engine.allocator.pages_free == 0
    assert engine.prepare_step() == [slot_b]
    with pytest.raises(OutOfPagesError, match="pool is dry"):
        engine.step()
    engine.release(slot_a)  # the scheduler's answer: preempt
    assert engine.prepare_step() == []
    engine.step()
    engine.page_table.check_invariants(engine.allocator)
    with pytest.raises(BadArgumentsError, match="pages"):
        port_engine(sd, num_pages=3).admit(Request(prompt=[1] * 40, params=SamplingParams(max_new=20)))


def test_reconfigure(weights):
    """reconfigure needs drained slots, then serves at the new width; the
    decode step has run at two shapes."""
    _, sd = weights
    engine = port_engine(sd)
    slot, _ = engine.admit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new=4)))
    engine.step()
    with pytest.raises(SlotOccupiedError, match="drain first"):
        engine.reconfigure(2)
    engine.release(slot)
    engine.reconfigure(2)
    assert engine.slots.num_slots == 2 and engine.cache.pages.shape[0] == 2
    assert engine.num_pages == 2 * 4 + 1
    got = drive(tserve, engine, jobs(tserve))
    assert got == drive(tserve, port_engine(sd), jobs(tserve))
    assert engine.compile_counts["decode"] == 2
    assert set(engine.memory.accounts()) == {"params", "kv_pages", "workspace"}
    with pytest.raises(BadArgumentsError):
        engine.reconfigure(0)


def test_surfaces_and_unported_parts(weights):
    _, sd = weights
    engine = port_engine(sd)
    drive(tserve, engine, jobs(tserve))
    assert engine.prefix_stats["prefix_hits"] == engine.prefix_hits > 0
    assert engine.paging_stats["paged"] and engine.paging_stats["pages_aliased_total"] > 0
    assert port_engine(sd, paged=False).paging_stats == {"paged": False}
    assert engine.spill_stream(0) is False
    assert engine.pages_held_peak(0) == 0 and engine.steps > 0 and engine.tokens_out > 0
    engine.set_max_pages_per_req(99)
    assert engine.max_pages_per_req == engine.pages_per_row
    # the host tier: releases spill prefix packs, and a prompt whose prefix
    # is no longer resident on the device fills from one
    tiered = port_engine(sd, tier=True)
    drive(tserve, tiered, jobs(tserve))
    assert tiered.tier_stats["prefix_spills"] > 0 and tiered.tier_stats["prefix_fills"] == 0
    tiered.admit(Request(prompt=SYS + [1, 2, 3], params=SamplingParams(max_new=2)))
    assert tiered.tier_stats["prefix_fills"] == 1 and tiered.tier_stats["fills"] == 1
    # the prefill handoff's pack: host K/V of the prompt's rows
    pack = engine.prefill_only(SYS + [4], SamplingParams())
    assert pack["plen"] == len(SYS) + 1 and pack["k"].device.type == "cpu"
    assert pack["k"].shape == (CFG.n_layers, len(SYS) + 1, CFG.n_kv_heads, CFG.head_dim)
    with pytest.raises(BadArgumentsError, match="stale handoff"):
        engine.admit_from_kv(Request(prompt=[1]), pack)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        port_engine(sd, mesh=object())
    with pytest.raises(BadArgumentsError, match="TRAINING config"):
        Engine(tt.DecoderConfig.tiny(decode=True), sd, device="cpu")


@pytest.fixture(scope="module")
def jax_handoff_streams(weights):
    """The JAX engine's greedy streams through ``prefill_only`` ->
    ``admit_from_kv``, paged-async and dense-sync."""
    params, _ = weights
    return {name: drive(jserve, jserve.Engine(JCFG, params, num_slots=3, **MODES[name]), jobs(jserve), handoff=True)
            for name in ("paged_async", "dense_sync")}


@pytest.mark.parametrize("mode", ["paged_async", "dense_sync"])
def test_prefill_handoff_streams(weights, jax_handoff_streams, mode):
    """``prefill_only`` -> ``admit_from_kv`` gives the stream ``admit``
    gives, bit for bit, greedy and sampled (without prefix reuse both run
    full prefills; the handoff's through a dense row of its own, the slot's
    through its paged or dense row), and the greedy streams equal JAX's
    handoff."""
    _, sd = weights
    for temperature in (0.0, 0.7):
        todo = jobs(tserve, temperature)
        handed = drive(tserve, port_engine(sd, prefix_reuse=False, **MODES[mode]), todo, handoff=True)
        assert handed == drive(tserve, port_engine(sd, prefix_reuse=False, **MODES[mode]), todo)
    assert drive(tserve, port_engine(sd, **MODES[mode]), jobs(tserve), handoff=True) == jax_handoff_streams[mode]


# --------------------------------------------------------- host-side units


def test_allocator_alloc_share_release():
    a = BlockAllocator(num_pages=9, page_size=PAGE)
    assert a.pages_total == 8 and a.pages_free == 8
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got  # the scratch page is never allocated
    a.share(got[:2])
    assert a.pages_shared == 2 and a.refcount(got[0]) == 2
    assert a.release(got[:2]) == 0 and a.pages_shared == 0
    assert a.release(got) == 3 and a.pages_free == 8
    a.check_invariants()


def _share_a_freed_page(a, got):
    page = a.alloc(1)[0]
    a.release([page])
    a.share([page])


@pytest.mark.parametrize("misuse, match", [
    (lambda a, got: a.alloc(2), None),  # only 1 free: all-or-nothing
    (lambda a, got: a.release([got[0]] * 3), "double free"),
    (lambda a, got: a.share([0]), "unallocated"),  # the scratch page is never shareable
    (_share_a_freed_page, "unallocated"),
])
def test_allocator_refuses_misuse(misuse, match):
    a = BlockAllocator(num_pages=5, page_size=PAGE)  # 4 usable
    got = a.alloc(3)
    with pytest.raises(OutOfPagesError if match is None else ValueError, match=match):
        misuse(a, got)
    if match is None:
        assert a.pages_free == 1, "a failed alloc must not leak pages"
    with pytest.raises(ValueError):
        BlockAllocator(num_pages=1, page_size=PAGE)


def test_allocator_soak_keeps_invariants():
    """Random alloc/share/release churn never breaks the invariants and
    never strands a page (free + referenced == total throughout)."""
    rng = np.random.default_rng(0)
    a = BlockAllocator(num_pages=33, page_size=8)
    held = []
    for _ in range(2000):
        op = rng.random()
        if op < 0.45 and a.pages_free:
            held.append(a.alloc(int(rng.integers(1, min(4, a.pages_free) + 1))))
        elif op < 0.6 and held:
            src = held[int(rng.integers(len(held)))]
            take = src[: int(rng.integers(1, len(src) + 1))]
            a.share(take)
            held.append(list(take))
        elif held:
            a.release(held.pop(int(rng.integers(len(held)))))
        a.check_invariants()
    for pages in held:
        a.release(pages)
    assert a.pages_free == a.pages_total
    a.check_invariants()


def test_page_table_mirror():
    a = BlockAllocator(num_pages=9, page_size=PAGE)
    t = PageTable(num_slots=2, max_pages=4)
    pages = a.alloc(2)
    t.assign(0, pages)
    assert list(t.table[0]) == pages + [0, 0]
    grown = a.alloc(1)[0]
    t.grow(0, grown)
    assert t.count(0) == 3 and t.pages(0) == pages + [grown]
    t.check_invariants(a)
    freed = t.clear(0)  # the row is zeroed: a released row's writes hit scratch
    assert freed == pages + [grown] and not t.table[0].any()
    a.release(freed)
    t.check_invariants(a)
    a.check_invariants()


def test_slot_manager_invariants():
    sm = SlotManager(2)
    r1, r2, r3 = (Request(prompt=[1, 2]) for _ in range(3))
    s1 = sm.admit(r1, first_token=5)
    s2 = sm.admit(r2, first_token=6)
    assert {s1, s2} == {0, 1} and not sm.free_slots()
    with pytest.raises(SlotOccupiedError, match="no free slot"):
        sm.admit(r3, first_token=7)
    sm.evict(s1)
    with pytest.raises(SlotOccupiedError, match="already in a slot"):
        sm.admit(r2, first_token=8)
    with pytest.raises(SlotOccupiedError, match="already free"):
        sm.evict(s1)
    s3 = sm.admit(r3, first_token=7)
    st = sm.get(s3)
    assert s3 == s1 and (st.next_pos, st.generated, st.last_token) == (2, 1, 7)
    sm.advance(s3, 9)
    assert (st.next_pos, st.last_token) == (3, 9)
    sm.check_invariants()


PREFIX_SYS = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


@pytest.mark.parametrize("residents, probe, want", [
    ({0: PREFIX_SYS + [11, 12, 13]}, PREFIX_SYS + [11, 12, 99], (0, 14)),  # LCP past the bucket
    ({0: PREFIX_SYS + [11, 12, 13]}, PREFIX_SYS[:6] + [99, 98, 97], None),  # under min_len
    ({0: PREFIX_SYS + [11, 12, 13]}, list(range(40, 60)), None),  # unrelated
    ({0: PREFIX_SYS + [11], 1: PREFIX_SYS + [21]}, PREFIX_SYS + [21, 5], (1, 13)),  # newest wins
    ({0: PREFIX_SYS[:8] + [70, 71, 72, 73, 74, 75, 76, 77], 1: PREFIX_SYS[:8] + [70, 71, 72, 73, 74, 75, 76, 99]},
     PREFIX_SYS[:8] + [70, 71, 72, 73, 74, 75, 76, 77, 1, 2], (0, 16)),  # longest bucket wins
])
def test_prefix_index_match(residents, probe, want):
    idx = PrefixIndex(min_len=8)
    for slot, prompt in residents.items():
        idx.insert(slot, prompt)
    assert idx.match(probe) == want
    for slot in residents:
        idx.remove(slot)
    assert idx.match(probe) is None and idx.resident() == {}
