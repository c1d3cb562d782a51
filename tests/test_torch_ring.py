"""The port's ring attention and sharding spec against the JAX package's.

Inputs come from numpy with a seed and go through both packages in fp32 on
the CPU: the port's ``ring_attention`` over a ``LocalRing`` (the per-step
plain versions of the ring kernels, in the ring's schedule) against the JAX
XLA ring (``impl="xla"``, shard_map + ppermute on the conftest's 8-device
CPU mesh) and against the Pallas ring kernels run by the TPU interpret
machine. Tolerances are those of ``tests/test_ring_flash.py``: 2e-5 for the
output and 5e-5 for the gradients (fp32, sums in another order).

Each JAX reference is traced and compiled as one program (output and
cotangents together). The interpret-mode Pallas ring takes about ten
seconds on the CPU; every other test here takes a few.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from maggy_tpu.parallel import ringattention as jring
from maggy_tpu.parallel.spec import MESH_AXES as J_MESH_AXES
from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
from maggy_tpu.util import set_mesh
from maggy_tpu_torch.models import Decoder, DecoderConfig, default_attention
from maggy_tpu_torch.ops import ring_flash as rf
from maggy_tpu_torch.parallel import (
    MESH_AXES,
    LocalRing,
    ShardingSpec,
    make_ring_attention,
    ring_attention,
)
from maggy_tpu_torch.train import TrainContext, Trainer, adamw, synthetic_lm_batches

torch.set_num_threads(2)
TOL_O = 2e-5
TOL_GRAD = 5e-5


def _inputs(b=2, s=32, h=4, kh=2, d=8, seed=0, packed=False):
    """q, k, v, a cotangent for the output, and (when ``packed``) segment ids
    with cuts that fall inside chunks, so segments cross chunk boundaries."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    segs = None
    if packed:
        segs = np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
    return q, k, v, g, segs


def _torch_ring(q, k, v, g, segs, n, causal):
    """Output and (dq, dk, dv) of the port's ring over ``LocalRing(n)``."""
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    seg = None if segs is None else torch.from_numpy(segs)
    out = ring_attention(*leaves, ring=LocalRing(n), causal=causal, segment_ids=seg)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_vjp(fn, q, k, v, g):
    """Output and cotangents of ``fn``, traced and compiled as one program."""

    @jax.jit
    def both(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    out, grads = both(*(jnp.asarray(t) for t in (q, k, v, g)))
    return np.asarray(out), [np.asarray(t) for t in grads]


def _assert_close(got, want):
    (o, grads), (o_ref, grads_ref) = got, want
    np.testing.assert_allclose(o, o_ref, atol=TOL_O, rtol=0)
    for name, a, r in zip(("dq", "dk", "dv"), grads, grads_ref):
        np.testing.assert_allclose(a, r, atol=TOL_GRAD, rtol=0, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_ring_matches_jax_xla_ring(n, causal, packed):
    q, k, v, g, segs = _inputs(packed=packed)
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    jsegs = None if segs is None else jnp.asarray(segs)

    def fn(q, k, v):
        return jring.ring_attention(q, k, v, mesh=mesh, causal=causal, segment_ids=jsegs, impl="xla")

    with set_mesh(mesh):
        want = _jax_vjp(fn, q, k, v, g)
    _assert_close(_torch_ring(q, k, v, g, segs, n, causal), want)


def test_ring_matches_interpret_mode_pallas_ring():
    """The Pallas ring kernels (in-kernel RDMA rotation, rotating dK/dV
    accumulators), run by the TPU interpret machine at n=2, S=32 as
    ``test_ring_flash_backward_kernel_parity`` runs them."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "InterpretParams"):
        pytest.skip("jax too old for the pallas TPU interpret machine")
    from maggy_tpu.ops.ring_flash import ring_flash_attention

    q, k, v, g, _ = _inputs(b=1, s=32, h=2, kh=2, d=8, seed=1)
    mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))

    def fn(q, k, v):
        return ring_flash_attention(q, k, v, mesh=mesh, causal=True, interpret=True)

    with set_mesh(mesh):
        want = _jax_vjp(fn, q, k, v, g)
    _assert_close(_torch_ring(q, k, v, g, None, 2, True), want)


@pytest.mark.parametrize("packed", [False, True])
def test_step_references_match_whole_sequence_attention(packed):
    """Two chunks by hand: rank 1's forward is its diagonal step, then the
    past chunk 0 (finalized); its dq sums both steps; chunk 0's dk/dv sum
    rank 0's diagonal step and rank 1's past step. All against autograd of
    the dense ``default_attention`` on the whole sequence."""
    q, k, v, g, segs = (None if t is None else torch.from_numpy(t)
                        for t in _inputs(packed=packed, seed=2))
    b, s, h, d = q.shape
    c = s // 2
    lo, hi = slice(0, c), slice(c, s)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = default_attention(*leaves, causal=True, segment_ids=segs)
    ref.backward(g)

    def sg(rows):
        return None if segs is None else segs[:, rows]

    acc = torch.empty(b, c, h, d)
    m, l, lse = (torch.empty(b, h, c) for _ in range(3))
    o = torch.empty(b, c, h, d)
    rf.ring_fwd_step_reference(q[:, hi], k[:, hi], v[:, hi], acc, m, l, o, lse, diagonal=True,
                               first=True, finalize_step=False, q_segs=sg(hi), k_segs=sg(hi))
    rf.ring_fwd_step_reference(q[:, hi], k[:, lo], v[:, lo], acc, m, l, o, lse, diagonal=False,
                               first=False, finalize_step=True, q_segs=sg(hi), k_segs=sg(lo))
    np.testing.assert_allclose(o, ref.detach()[:, hi], atol=TOL_O, rtol=0)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(h // k.shape[2], 2)) / d**0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    if segs is not None:
        mask = mask & (segs[:, :, None] == segs[:, None, :])[:, None]
    want_lse = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), -1)
    np.testing.assert_allclose(lse, want_lse[..., hi], atol=TOL_O, rtol=0)

    # rank 0's forward is its diagonal step alone
    o0, lse0 = torch.empty(b, c, h, d), torch.empty(b, h, c)
    rf.ring_fwd_step_reference(q[:, lo], k[:, lo], v[:, lo], acc, m, l, o0, lse0, diagonal=True,
                               first=True, finalize_step=True, q_segs=sg(lo), k_segs=sg(lo))
    dq1 = torch.empty(b, c, h, d)
    dk0, dv0 = torch.empty(b, c, k.shape[2], d), torch.empty(b, c, k.shape[2], d)
    for step, (qr, kr, o_r, lse_r, diagonal) in enumerate(((hi, hi, o, lse, True), (hi, lo, o, lse, False))):
        rf.ring_dq_step_reference(q[:, qr], k[:, kr], v[:, kr], o_r, g[:, qr], lse_r, dq1,
                                  diagonal=diagonal, first=step == 0, q_segs=sg(qr), k_segs=sg(kr))
    for step, (qr, o_r, lse_r, diagonal) in enumerate(((lo, o0, lse0, True), (hi, o, lse, False))):
        rf.ring_dkv_step_reference(q[:, qr], k[:, lo], v[:, lo], o_r, g[:, qr], lse_r, dk0, dv0,
                                   diagonal=diagonal, first=step == 0, q_segs=sg(qr), k_segs=sg(lo))
    np.testing.assert_allclose(dq1, leaves[0].grad[:, hi], atol=TOL_GRAD, rtol=0)
    np.testing.assert_allclose(dk0, leaves[1].grad[:, lo], atol=TOL_GRAD, rtol=0)
    np.testing.assert_allclose(dv0, leaves[2].grad[:, lo], atol=TOL_GRAD, rtol=0)


def test_decoder_through_local_ring_matches_dense():
    """The slice as a whole on the CPU: a Decoder attending over
    ``LocalRing(4)`` gives the logits and gradients of the same weights with
    the dense ``default_attention``, and a ``TrainContext.local`` trainer
    steps it."""
    cfg = DecoderConfig.tiny(dtype=torch.float32)
    ring_cfg = DecoderConfig.tiny(dtype=torch.float32, attention_fn=make_ring_attention(LocalRing(4)))
    dense = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ringed = Decoder(ring_cfg, device="meta")
    ringed.load_state_dict(dense.state_dict(), assign=True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    want, got = dense(tokens), ringed(tokens)
    np.testing.assert_allclose(got.detach(), want.detach(), atol=TOL_GRAD, rtol=0)
    want.square().mean().backward()
    got.square().mean().backward()
    for (name, p), r in zip(ringed.named_parameters(), dense.parameters()):
        np.testing.assert_allclose(p.grad, r.grad, atol=TOL_GRAD, rtol=1e-4, err_msg=name)

    ctx = TrainContext.local(ShardingSpec(sp=4), device="cpu")
    model = Decoder(DecoderConfig.tiny(attention_fn=make_ring_attention(ctx.ring)), device="meta")
    trainer = ctx.trainer(model, adamw(1e-3))
    data = synthetic_lm_batches(cfg.vocab_size, 2, 32, seed=0)
    state = trainer.make_state(0, next(data))
    rf.reset_launches()
    state, metrics = trainer.step(state, ctx.shard_batch(next(data)))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert rf.LAUNCHES == {"ring_fwd": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}  # plain versions


@pytest.mark.parametrize("preset", ["dp", "fsdp", "tp", "sp", "pp", "2d", "ep"])
def test_sharding_spec_matches_jax(preset):
    """The sp preset is the JAX package's; every preset that turns on an axis
    the port does not run yet is refused where JAX builds it."""
    assert MESH_AXES == J_MESH_AXES
    for n in (1, 4, 8):
        ref = JShardingSpec.preset(preset, n)
        if preset == "sp":
            mine = ShardingSpec.preset(preset, n)
            assert (mine.sp, mine.num_devices) == (ref.sp, ref.num_devices)
        else:
            with pytest.raises(NotImplementedError, match="queue 1 item 7"):
                ShardingSpec.preset(preset, n)


@pytest.mark.parametrize("case", ["uneven_seq", "bad_ring", "sp_1", "dp_axis", "zero_stage",
                                  "no_process_group", "bad_spec", "unknown_field"])
def test_refused_calls_raise(case):
    q = torch.zeros(1, 30, 2, 8)
    if case == "uneven_seq":  # 30 tokens do not cut into 4 equal chunks
        with pytest.raises(ValueError, match="equal ring chunks"):
            ring_attention(q, q[:, :, :1], q[:, :, :1], ring=LocalRing(4))
    elif case == "bad_ring":  # a ring is never chosen silently
        with pytest.raises(TypeError, match="LocalRing or a ProcessGroupRing"):
            ring_attention(q, q, q, ring=4)
        with pytest.raises(TypeError, match="LocalRing or a ProcessGroupRing"):
            Trainer(Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), device="cpu", ring=2)
    elif case == "sp_1":
        with pytest.raises(ValueError, match="sp > 1"):
            TrainContext.local(ShardingSpec(sp=1), device="cpu")
    elif case == "dp_axis":
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            TrainContext.local(ShardingSpec(sp=2, dp=2), device="cpu")
    elif case == "zero_stage":
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            TrainContext.local(ShardingSpec(sp=2, zero_stage=1), device="cpu")
    elif case == "no_process_group":
        with pytest.raises(RuntimeError, match="process group"):
            TrainContext.create(ShardingSpec(sp=2), device="cpu")
    elif case == "bad_spec":
        with pytest.raises(ValueError, match="positive int"):
            ShardingSpec(sp=0)
    elif case == "unknown_field":
        with pytest.raises(TypeError, match="unknown fields"):
            ShardingSpec(sp=2, spp=2)
        assert ShardingSpec(sp=2, dp=1, zero_stage=0, bucket_mb=None) == ShardingSpec(sp=2)


def test_ring_kernels_raise_on_cpu_tensors():
    """The kernel wrappers launch or raise: CPU tensors reach them only by a
    direct call, which refuses."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    acc, m, l, lse = torch.zeros(1, 64, 2, 64), *(torch.zeros(1, 2, 64) for _ in range(3))
    kw = dict(diagonal=True, first=True)
    with pytest.raises(ValueError, match="not CUDA"):
        rf.ring_fwd(q, k, k, acc, m, l, q, lse, finalize_step=False, **kw)
    with pytest.raises(ValueError, match="not CUDA"):
        rf.ring_bwd_dq(q, k, k, q, q, lse, acc, **kw)
    with pytest.raises(ValueError, match="not CUDA"):
        rf.ring_bwd_dkv(q, k, k, q, q, lse, acc[:, :, :1], acc[:, :, :1], **kw)
    assert rf.step_functions(q)[0] is rf.ring_fwd_step_reference
    with pytest.raises(ValueError, match="cuda or cpu"):
        rf.step_functions(q.to("meta"))
