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
