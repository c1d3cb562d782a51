"""The port's Ulysses attention (``parallel/ulysses.py``: ``all_to_all_single``
over a mesh's ``seq`` axis) on gloo ranks against the JAX package's
``ulysses_attention``, whose inner attention is its default
``blockwise_attention``; the port's is the flash wrapper, which on CPU
tensors runs the kernels' plain versions.

One spawned world of four CPU ranks (every wait under ``TIMEOUT_S``)
computes each case on a mesh of ``ShardingSpec(sp=4)`` or
``ShardingSpec(sp=2, dp=2)``: each rank passes its chunk of the global
q/k/v (chunk r for its ``seq`` rank r), and the chunks of the output and
of the gradients of ``sum(o * cos(o))`` are put back together here. The
JAX side runs on the conftest's CPU devices over the same arrays.

* causal and not, H = Kh = 8 at sp=4 (``tests/test_attention_ops.py::
  test_ulysses_matches_reference``);
* GQA with ``sp`` not dividing the KV heads (4 / 2 heads at sp=4, 4 / 1 at
  sp=2): the KV heads repeated, as JAX repeats them;
* packed segment ids, forward and gradients, at sp=4 and sp=2
  (``tests/test_packed_sequences.py::test_ulysses_segment_parity_sp4``;
  the ids all-gathered to full length), also against attention run on
  each segment alone;
* a head count the axis does not divide raises ``ValueError`` on every
  rank, before any collective;
* the tiny Decoder trained three steps under ``make_ulysses_attention``
  at sp=2 x dp=2 against JAX's Trainer under the same spec and attention.

Limits (fp32): outputs 2e-5 absolute, gradients 5e-5 absolute (JAX's own
tests' limits), the Decoder's losses and grad norms 2e-5 relative.
"""

import functools
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import ShardingSpec, make_mesh, make_ulysses_attention, ulysses_attention
from maggy_tpu_torch.train import TrainContext, adamw

TIMEOUT_S = 150
N = 4
OUT_ATOL = 2e-5
GRAD_ATOL = 5e-5
RTOL = 2e-5
LR = 5e-3
STEPS = 3
B, S = 4, 32
# name: (mesh spec, b, s, h, kh, causal, packed)
CASES = {
    "causal_sp4": (dict(sp=4), 2, 64, 8, 8, True, False),
    "full_sp4": (dict(sp=4), 2, 64, 8, 8, False, False),
    "gqa_repeat_sp4": (dict(sp=4), 2, 64, 4, 2, True, False),
    "gqa_repeat_sp2_dp2": (dict(sp=2, dp=2), 2, 64, 4, 1, True, False),
    "packed_sp4": (dict(sp=4), 2, 128, 4, 2, True, True),
    "packed_sp2_dp2": (dict(sp=2, dp=2), 2, 128, 4, 4, True, True),
}


def case_arrays(b, s, h, kh, packed, seed=0, d=16):
    """q, k, v (fp32) and, when ``packed``, segment ids of three uneven
    segments a row (the second row's numbered apart)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    seg = None
    if packed:
        row = np.zeros(s, np.int32)
        for cut in np.sort(rng.choice(np.arange(8, s - 8), size=2, replace=False)):
            row[cut:] += 1
        seg = np.stack([row, (row + 1) % 3 + 10])[:b].astype(np.int32)
    return q, k, v, seg


def _attention_case(spec_kw, b, s, h, kh, causal, packed):
    """This rank's chunk of the output and of dq/dk/dv."""
    mesh = make_mesh(ShardingSpec(**spec_kw), "cpu")
    n, r = mesh.mesh.shape[mesh.mesh_dim_names.index("seq")], mesh.get_local_rank("seq")
    c = s // n
    q, k, v, seg = case_arrays(b, s, h, kh, packed)
    mine = [torch.from_numpy(x[:, r * c:(r + 1) * c].copy()).requires_grad_(True) for x in (q, k, v)]
    seg_mine = None if seg is None else torch.from_numpy(seg[:, r * c:(r + 1) * c].copy())
    o = ulysses_attention(*mine, mesh=mesh, causal=causal, segment_ids=seg_mine)
    (o * torch.cos(o)).sum().backward()
    return dict(seq_rank=r, n=n, o=o.detach().numpy(), grads=[t.grad.numpy() for t in mine])


def _decoder_case(params, batches):
    ctx = TrainContext.create(ShardingSpec(sp=2, dp=2), device="cpu")
    cfg = DecoderConfig.tiny(dtype=torch.float32, attention_fn=make_ulysses_attention(ctx.mesh))
    trainer = ctx.trainer(Decoder(cfg, device="meta"), functools.partial(adamw(LR), foreach=True))
    state = trainer.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in params.items()})
    losses, norms = [], []
    for batch in batches[1:]:
        state, m = trainer.step(state, ctx.shard_batch(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms)


def _rank(rank, init_file, out, params, batches):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=N)
        results = {name: _attention_case(*case) for name, case in CASES.items()}
        mesh = make_mesh(ShardingSpec(sp=4), "cpu")
        try:  # 2 heads over 4 ranks
            q = torch.zeros(1, 8, 2, 16)
            ulysses_attention(q, q, q, mesh=mesh)
            results["divisibility"] = None
        except ValueError as e:
            results["divisibility"] = str(e)
        results["decoder"] = _decoder_case(params, batches)
        out.put((rank, results))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _run_ranks(tmp, *args):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "rendezvous"), out, *args)) for r in range(N)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=TIMEOUT_S) for _ in range(N)), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [f"rank {r[0]} failed:\n{r[2]}" for r in results if isinstance(r[1], str) and r[1] == "error"]
    if failed:
        raise AssertionError("\n".join(failed))
    return [r[1] for r in results]


def packed_batches(vocab: int, n: int, seed: int = 0):
    """``n`` packed batches with a loss mask, as ``tests/test_torch_dist_train.py``'s."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cuts = [np.sort(rng.choice(np.arange(4, S - 4), rng.integers(0, 3), replace=False)) for _ in range(B)]
        seg = np.stack([np.searchsorted(c, np.arange(S), side="right") for c in cuts]).astype(np.int32)
        pos = np.stack([np.arange(S) - np.concatenate([[0], c])[s] for c, s in zip(cuts, seg)]).astype(np.int32)
        out.append({"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32), "positions": pos,
                    "segment_ids": seg, "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.models.transformer import default_attention
    from maggy_tpu.parallel.mesh import make_mesh as jmake_mesh
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.parallel.ulysses import make_ulysses_attention as jmake_ulysses_attention
    from maggy_tpu.parallel.ulysses import ulysses_attention as julysses_attention
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.convert import decoder_params_from_flax

    ref = {}
    for name, (spec_kw, b, s, h, kh, causal, packed) in CASES.items():
        n = spec_kw["sp"]
        mesh = jmake_mesh(JShardingSpec(sp=n, dp=8 // n))
        q, k, v, seg = case_arrays(b, s, h, kh, packed)
        seg_j = None if seg is None else jnp.asarray(seg)

        def loss(q, k, v):
            o = julysses_attention(q, k, v, mesh=mesh, causal=causal, segment_ids=seg_j)
            return (o * jnp.cos(o)).sum(), o

        with mesh:
            (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        segwise = None
        if packed:  # attention run on each segment alone
            segwise = np.zeros(q.shape, np.float32)
            for row in range(b):
                for sid in np.unique(seg[row]):
                    idx = np.where(seg[row] == sid)[0]
                    segwise[row, idx] = np.asarray(default_attention(
                        q[row:row + 1, idx], k[row:row + 1, idx], v[row:row + 1, idx], causal=causal))[0]
        ref[name] = dict(o=np.asarray(o), grads=[np.asarray(g) for g in grads], segwise=segwise)
    # the Decoder under Ulysses at sp=2 x dp=2
    spec = JShardingSpec(sp=2, dp=2)
    jctx = JTrainContext.create(spec, devices=jax.devices()[:4])
    jcfg = JConfig.tiny(dtype=jnp.float32, attention_fn=jmake_ulysses_attention(jctx.mesh))
    jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), packed_batches(jcfg.vocab_size, 1)[0])
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    params = {k: v.numpy() for k, v in decoder_params_from_flax(jax.device_get(unbox(jstate.params)), tcfg).items()}
    batches = packed_batches(jcfg.vocab_size, STEPS + 1)
    jl, jg = [], []
    for batch in batches[1:]:
        jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
        jl.append(float(jm["loss"]))
        jg.append(float(jm["grad_norm"]))
    ranks = _run_ranks(tmp_path_factory.mktemp("ulysses"), params, batches)
    return dict(ref=ref, ranks=ranks, decoder=dict(losses=jl, norms=jg))


def _assembled(ranks, name):
    """The chunks of output and gradients in sequence order (a dp replica's
    chunks are the same; one is taken)."""
    by_chunk = {}
    for rank in ranks:
        by_chunk.setdefault(rank[name]["seq_rank"], rank[name])
    parts = [by_chunk[r] for r in sorted(by_chunk)]
    o = np.concatenate([p["o"] for p in parts], axis=1)
    grads = [np.concatenate([p["grads"][i] for p in parts], axis=1) for i in range(3)]
    return o, grads, parts


@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_matches_jax(run, name):
    o, grads, parts = _assembled(run["ranks"], name)
    assert len(parts) == CASES[name][0]["sp"]
    ref = run["ref"][name]
    np.testing.assert_allclose(o, ref["o"], rtol=0, atol=OUT_ATOL)
    for got, want in zip(grads, ref["grads"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL)
    if ref["segwise"] is not None:
        np.testing.assert_allclose(o, ref["segwise"], rtol=0, atol=OUT_ATOL)
    for rank in run["ranks"]:  # dp replicas agree with each other exactly
        other = parts[rank[name]["seq_rank"]]
        assert np.array_equal(rank[name]["o"], other["o"])


def test_ulysses_head_divisibility(run):
    for rank in run["ranks"]:
        assert rank["divisibility"] is not None and "divide the head count" in rank["divisibility"]
        assert "ring attention" in rank["divisibility"]


def test_decoder_under_ulysses_matches_jax(run):
    want = run["decoder"]
    assert want["losses"][-1] < want["losses"][0]
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["decoder"]["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(rank["decoder"]["norms"], want["norms"], rtol=RTOL)
