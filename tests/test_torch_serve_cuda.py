"""The serving path on the card, at a small bf16 config.

These need a CUDA card: they skip elsewhere. On the card, run them without
the JAX package's test configuration:

    python -m pytest tests/test_torch_serve_cuda.py -q --noconftest

Streams are compared bit for bit only between runs that compute the same
shapes (paged against dense, async against sync); across different numeric
paths (the cache path against the training forward) logits are compared
under the chip smoke's limit, 3e-2 relative L2 per position, since greedy
tokens of a random bf16 model can differ on a near-tie.
"""

import os
import time

import pytest
import torch

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.models.generate import generate, init_cache
from maggy_tpu_torch.ops import flash
from maggy_tpu_torch.serve import Engine, Request, SamplingParams

pytestmark = pytest.mark.cuda

# head_dim 64: the training forward's flash kernel takes it
CFG = DecoderConfig.tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                         max_seq_len=512, decode_chunk=64)
TOL_ROW_REL_L2 = 3e-2
SYS = list(range(100, 180))  # an 80-token shared prefix: 5 full pages of 16


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dev):
    return Decoder(CFG, device=dev, generator=torch.Generator(device=dev).manual_seed(0))


def _jobs():
    out = []
    for i in range(8):
        prompt = (SYS if i % 2 == 0 else []) + [(7 * i + j) % 1000 + 1 for j in range(5 + 23 * i)]
        sampled = i % 3 == 1
        out.append((prompt, SamplingParams(max_new=6 + 5 * i, temperature=0.8 if sampled else 0.0,
                                           top_k=40 if sampled else 0, seed=i)))
    return out


def _drive(engine, jobs):
    pending = list(enumerate(jobs))
    streams, owner = {}, {}
    while pending or engine.slots.active_count:
        while pending and engine.slots.free_slots():
            i, (prompt, sp) = pending.pop(0)
            slot, first = engine.admit(Request(prompt=prompt, params=sp))
            streams[i], owner[slot] = [first], i
        for slot, tok in engine.step().tokens.items():
            i = owner[slot]
            streams[i].append(tok)
            if len(streams[i]) >= jobs[i][1].max_new:
                engine.release(slot)
    engine.flush()
    return [streams[i] for i in range(len(jobs))]


def test_paged_equals_dense_and_async_equals_sync(dev):
    model = _model(dev)
    runs = {}
    for paged in (True, False):
        for async_decode in (True, False):
            engine = Engine(CFG, model, num_slots=3, paged=paged, async_decode=async_decode)
            runs[paged, async_decode] = _drive(engine, _jobs())
            assert engine.prefix_hits > 0 and engine.compile_counts["decode"] == 1
    first = runs[True, True]
    assert all(streams == first for streams in runs.values())
    assert all(len(s) == sp.max_new for s, (_, sp) in zip(first, _jobs()))


def test_steady_state_dispatch_has_no_hidden_sync(dev):
    """Once the slot set is unchanged, the dispatch half of step() builds no
    host array and reads nothing back: it runs under the sync debug mode."""
    engine = Engine(CFG, _model(dev), num_slots=4)
    for prompt, _ in _jobs()[:4]:
        engine.admit(Request(prompt=prompt, params=SamplingParams(max_new=64, temperature=0.5, top_k=8)))
    engine.step()
    engine.step()  # from here on every input is the previous step's output
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            prev, dispatched = engine._dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        engine._pending = dispatched
        assert len(engine._drain(prev).tokens) == 4


def test_cache_path_logits_against_the_training_forward(dev):
    """Prefill and greedy steps through a dense cache, rows at different
    positions; the training forward (the flash kernel) over the same tokens
    gives each position's logits within the limit. The cache path launches
    no kernel; the training forward launches the forward kernel per layer."""
    model = _model(dev)
    lens = [37, 100]
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = [torch.randint(0, CFG.vocab_size, (n,), generator=gen, device=dev) for n in lens]
    cache = init_cache(CFG, torch.zeros((2, 1), device=dev))
    flash.reset_launches()
    with torch.no_grad():
        got = [[model(p[None], torch.arange(len(p), device=dev)[None], cache=cache.row(i), kv_len=len(p))[0]]
               for i, p in enumerate(prompts)]
        tokens = torch.stack([g[0][-1].argmax() for g in got])
        fed = [[] for _ in prompts]
        for j in range(8):
            for i in range(2):
                fed[i].append(tokens[i])
            pos = torch.tensor(lens, device=dev)[:, None] + j
            out = model(tokens[:, None], pos, cache=cache, kv_len=max(lens) + j + 1)
            for i in range(2):
                got[i].append(out[i])
            tokens = out[:, 0].argmax(-1)
        assert all(v == 0 for v in flash.LAUNCHES.values())
        for i, p in enumerate(prompts):
            ref = model(torch.cat([p, torch.stack(fed[i])])[None])[0]
            mine = torch.cat(got[i])
            err = (mine - ref).norm(dim=-1) / ref.norm(dim=-1)
            assert float(err.max()) <= TOL_ROW_REL_L2, float(err.max())
    assert flash.LAUNCHES["flash_fwd"] == 2 * CFG.n_layers


def test_recompute_generate_runs_the_flash_kernel(dev):
    model = _model(dev)
    prompt = torch.zeros((2, 24), dtype=torch.int64, device=dev)
    prompt[:, :5] = torch.arange(1, 6, device=dev)
    flash.reset_launches()
    out = generate(model, prompt, torch.tensor([5, 3], device=dev))
    assert out.shape == (2, 24) and flash.LAUNCHES["flash_fwd"] == 23 * CFG.n_layers


# ------------------------------------------- host tier, handoff, scheduler


def test_bf16_spill_swap_in_round_trip(dev):
    """A bf16 stream spilled to the host tier and swapped back in: the
    restored pages hold the spilled bytes bit for bit, and the stream equals
    an uninterrupted one (the one token sampled but never fed back runs at
    the decode step's shapes)."""
    model = _model(dev)
    prompt, sp = SYS + list(range(1, 40)), SamplingParams(max_new=24, temperature=0.8, top_k=40, seed=3)
    free = _drive(Engine(CFG, model, num_slots=8, tier=False), [(prompt, sp)])[0]
    engine = Engine(CFG, model, num_slots=8)
    assert engine.tier is not None and engine.tier.pin_memory
    req = Request(id="r", prompt=list(prompt), params=sp)
    slot, first = engine.admit(req)
    req.tokens.append(first)
    for _ in range(6):
        req.tokens.extend(engine.step().tokens.values())
    req.tokens.extend(engine.flush().tokens.values())
    valid = len(prompt) + len(req.tokens) - 1
    pages = engine.page_table.pages(slot)[: -(-valid // engine.page_size)]
    before = engine.cache.k[:, pages].reshape(CFG.n_layers, -1, CFG.n_kv_heads, CFG.head_dim)[:, :valid].clone()
    assert engine.spill_stream(slot)
    engine.release(slot)
    blocks, meta = engine.tier.get(f"rid:{req.id}")
    assert blocks["k"].dtype == torch.bfloat16 and meta["valid"] == valid
    resumed = Request(id="r", prompt=list(prompt), params=sp, tokens=list(req.tokens))
    slot2, first2 = engine.admit(resumed)
    pages2 = engine.page_table.pages(slot2)[: len(pages)]
    after = engine.cache.k[:, pages2].reshape(CFG.n_layers, -1, CFG.n_kv_heads, CFG.head_dim)[:, :valid]
    assert torch.equal(after.view(torch.int16), before.view(torch.int16))
    stream = list(req.tokens) + [first2]
    while len(stream) < sp.max_new:
        stream.extend(engine.step().tokens.values())
    assert stream[: sp.max_new] == free
    assert engine.tier_stats["fills"] == 1


def test_admit_from_kv_on_cuda(dev):
    """prefill_only -> admit_from_kv on the card gives admit's streams bit
    for bit (both full prefills: prefix reuse off), paged and dense."""
    model = _model(dev)
    for paged in (True, False):
        jobs = _jobs()
        plain = _drive(Engine(CFG, model, num_slots=3, paged=paged, prefix_reuse=False), jobs)
        engine = Engine(CFG, model, num_slots=3, paged=paged, prefix_reuse=False)
        pending, streams, owner = list(enumerate(jobs)), {}, {}
        while pending or engine.slots.active_count:
            while pending and engine.slots.free_slots():
                i, (prompt, sp) = pending.pop(0)
                pack = engine.prefill_only(prompt, sp)
                assert pack["k"].device.type == "cpu" and pack["k"].dtype == torch.bfloat16
                slot, first = engine.admit_from_kv(Request(prompt=prompt, params=sp), pack)
                streams[i], owner[slot] = [first], i
            for slot, tok in engine.step().tokens.items():
                streams[owner[slot]].append(tok)
                if len(streams[owner[slot]]) >= jobs[owner[slot]][1].max_new:
                    engine.release(slot)
        engine.flush()
        assert [streams[i] for i in range(len(jobs))] == plain


def test_forced_profile_capture_takes_a_torch_profiler_trace(dev, tmp_path):
    from maggy_tpu_torch.telemetry.alerts import ALERT_FIRING
    from maggy_tpu_torch.telemetry.profcap import ProfileCapture

    pc = ProfileCapture(dump_dir=str(tmp_path), device=dev, trace_s=0.2)
    path = pc.tick([{"event": ALERT_FIRING, "alert": "alert.hbm_headroom"}], now=1.0)
    assert pc.last_capture["profiler"] == "torch.profiler"
    assert sorted(os.listdir(path)) == ["capture.json", "trace.json"]


def test_scheduler_serves_an_engine_named_cuda_without_an_index(dev):
    """``device="cuda"`` names the current card on the engine, so the
    scheduler's loop thread can make it current."""
    from maggy_tpu_torch.serve import Scheduler

    engine = Engine(CFG, _model(dev), num_slots=2, device="cuda")
    assert engine.device == torch.device("cuda", torch.cuda.current_device())
    sched = Scheduler(engine)
    req = sched.submit([1, 2, 3], SamplingParams(max_new=4))
    sched.start()
    try:
        deadline = time.time() + 60
        while req.state not in ("done", "failed") and time.time() < deadline:
            time.sleep(0.01)
    finally:
        sched.stop()
    assert req.state == "done" and len(req.tokens) == 4, (req.state, req.error)


def test_scheduler_on_the_second_card_leaves_the_first_alone(dev):
    """A Scheduler whose engine is on cuda:1 makes that card current in its
    loop thread: nothing is allocated on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from maggy_tpu_torch.serve import Scheduler

    other = torch.device("cuda", 1)
    engine = Engine(CFG, _model(other), num_slots=3, device=other)
    torch.cuda.synchronize(0)
    base = torch.cuda.memory_allocated(0)
    sched = Scheduler(engine)
    reqs = [sched.submit(prompt, sp) for prompt, sp in _jobs()]  # queued before the loop runs
    sched.start()
    try:
        deadline = time.time() + 120
        while any(r.state not in ("done", "failed") for r in reqs) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        sched.stop()
    assert all(r.state == "done" for r in reqs), [(r.state, r.error) for r in reqs]
    assert [r.tokens for r in reqs] == _drive(Engine(CFG, _model(other), num_slots=3, device=other), _jobs())
    assert torch.cuda.memory_allocated(0) == base


def test_fleet_replicas_share_one_copy_of_the_weights_on_the_card(dev):
    """Three replicas leased on one card build their engines over one
    serving state: every projection weight is one storage, and the three
    replicas together hold one bf16 copy of the projections."""
    from maggy_tpu_torch.models.transformer import Dense
    from maggy_tpu_torch.serve.fleet import ReplicaSpec, build_replicas

    model = _model(dev)
    fleet = build_replicas(ReplicaSpec(CFG, model.state_dict(), num_slots=2, device="cuda:0"), 3, "s3cret")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(0)
    for r in fleet:
        r.start()
    try:
        engines = [r.server.scheduler.engine for r in fleet]
        names = [n for n, m in engines[0].model.named_modules() if isinstance(m, Dense)]
        for n in names:
            ptrs = {e.model.get_submodule(n).weight.data_ptr() for e in engines}
            assert len(ptrs) == 1, n
            assert engines[0].model.get_submodule(n).weight.dtype == CFG.dtype
        # the engines added their KV pools and workspaces, not weights
        pools = sum(e.cache.k.numel() * e.cache.k.element_size() * 2 for e in engines)
        dense_bytes = sum(engines[0].model.get_submodule(n).weight.numel() * 2 for n in names)
        assert torch.cuda.memory_allocated(0) - before < pools + dense_bytes
    finally:
        for r in fleet:
            r.stop(drain=False)


def test_killed_replica_frees_its_kv_pool_without_the_collector(dev):
    """``Replica.kill()`` lets go of the engine: its KV pool leaves the card
    with the cyclic collector off, and a respawn brings the card's memory
    back to its value before the kill."""
    import gc

    from maggy_tpu_torch.serve.fleet import ReplicaSpec, build_replicas

    fleet = build_replicas(ReplicaSpec(CFG, _model(dev).state_dict(), num_slots=4, device="cuda:0"), 2, "s3cret")
    for r in fleet:
        r.start()
    try:
        cache = fleet[1].server.scheduler.engine.cache
        pool = cache.k.numel() * cache.k.element_size() * 2
        del cache
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(0)
        gc.disable()
        try:
            fleet[1].kill()
            torch.cuda.synchronize()
            freed = before - torch.cuda.memory_allocated(0)
            fleet[1].respawn()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(0)
        finally:
            gc.enable()
        assert freed >= pool, (freed, pool)
        assert abs(after - before) < pool // 4, (after, before)
        assert fleet[1].alive() and fleet[1].restarts == 1
    finally:
        for r in fleet:
            r.stop(drain=False)
