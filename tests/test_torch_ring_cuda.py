"""The ring-attention step kernels on the card against their plain versions.

These need a CUDA card and the CUDA toolkit: they skip elsewhere. On the
card, run them without the JAX package's test configuration:

    python -m pytest tests/test_torch_ring_cuda.py -q --noconftest

Inputs are bf16 from a seeded generator; the plain versions run in fp32 from
the same inputs and the same fp32 state. Tolerances as for the flash kernels
(``tests/test_torch_cuda.py``): O 2e-2 absolute and 1e-2 relative L2, the
LSE and the running max 1e-3 absolute, the fp32 state (acc, l) and dq/dk/dv
2e-2 relative L2 (P and dS are rounded to bf16 before their products).
"""

import pytest
import torch

from maggy_tpu_torch.ops import ring_flash as rf
from maggy_tpu_torch.parallel.ringattention import LocalRing, ring_attention

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, r):
    return float((a.float() - r.float()).norm() / r.float().norm())


def _chunks(dev, b, c, h, kh, d, packed, seed=0):
    """A q chunk, two KV chunks (its own and a past one), dO, and segment ids
    of a sequence cut at 0.6 C and 1.5 C, so a segment crosses the chunks."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, do = rand(b, c, h, d), rand(b, c, h, d)
    kv = [(rand(b, c, kh, d), rand(b, c, kh, d)) for _ in range(2)]
    segs = [None, None]
    if packed:
        pos = torch.arange(2 * c, device=dev)
        s = ((pos >= int(0.6 * c)).int() + (pos >= int(1.5 * c)).int())[None].repeat(b, 1)
        segs = [s[:, c:], s[:, :c]]  # q's chunk is the second; the past chunk the first
    return q, do, kv, segs


def _state(b, c, h, d, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(b, c, h, d, **f32), torch.empty(b, h, c, **f32), torch.empty(b, h, c, **f32),
            torch.empty(b, c, h, d, dtype=torch.bfloat16, device=dev), torch.empty(b, h, c, **f32))


def _assert_state(mine, ref):
    assert _rel(mine[0], ref[0]) <= 2e-2 and _rel(mine[2], ref[2]) <= 2e-2
    assert float((mine[1] - ref[1]).abs().max()) <= 1e-3


def _check_steps(dev, b, c, h, kh, d, packed):
    """A rank's two steps, each kernel against its plain version: the
    diagonal (first, state kept), the past chunk from that state (kept, and
    finalized), dQ of both, each chunk's dK/dV stored, and the past chunk's
    dK/dV added to the diagonal's accumulators."""
    q, do, ((k0, v0), (k1, v1)), (qs, ps) = _chunks(dev, b, c, h, kh, d, packed)
    f = lambda t: t.float()  # noqa: E731
    rf.reset_launches()
    mine, ref = _state(b, c, h, d, dev), _state(b, c, h, d, dev)
    kw0 = dict(diagonal=True, first=True, finalize_step=False, q_segs=qs, k_segs=qs)
    rf.ring_fwd(q, k0, v0, *mine, **kw0)
    rf.ring_fwd_step_reference(f(q), f(k0), f(v0), *ref[:3], ref[3].float(), ref[4], **kw0)
    _assert_state(mine, ref)
    after_diagonal = [r.clone() for r in ref[:3]]
    o_ref = torch.empty(b, c, h, d, device=dev)
    for finalize in (False, True):  # both start from one state
        for t, r, x in zip(mine[:3], ref[:3], after_diagonal):
            t.copy_(x)
            r.copy_(x)
        kw1 = dict(diagonal=False, first=False, finalize_step=finalize, q_segs=qs, k_segs=ps)
        rf.ring_fwd(q, k1, v1, *mine, **kw1)
        rf.ring_fwd_step_reference(f(q), f(k1), f(v1), *ref[:3], o_ref, ref[4], **kw1)
        if not finalize:
            _assert_state(mine, ref)
    o, lse = mine[3], mine[4]
    assert float((o.float() - o_ref).abs().max()) <= 2e-2 and _rel(o, o_ref) <= 1e-2
    assert float((lse - ref[4]).abs().max()) <= 1e-3

    # backward of both steps into one dq and the two chunks' accumulators
    dq, dq_ref = (torch.empty(b, c, h, d, device=dev) for _ in range(2))
    dkv = [[torch.empty(b, c, kh, d, device=dev) for _ in range(2)] for _ in range(2)]
    dkv_ref = [[torch.empty(b, c, kh, d, device=dev) for _ in range(2)] for _ in range(2)]
    for i, (k, v, kseg, diagonal) in enumerate(((k0, v0, qs, True), (k1, v1, ps, False))):
        kw = dict(diagonal=diagonal, first=i == 0, q_segs=qs, k_segs=kseg)
        rf.ring_bwd_dq(q, k, v, o, do, lse, dq, **kw)
        rf.ring_dq_step_reference(f(q), f(k), f(v), f(o), f(do), lse, dq_ref, **kw)
        kw["first"] = True  # each chunk's own accumulators start here
        rf.ring_bwd_dkv(q, k, v, o, do, lse, *dkv[i], **kw)
        rf.ring_dkv_step_reference(f(q), f(k), f(v), f(o), f(do), lse, *dkv_ref[i], **kw)
    # accumulate: the past step added to the diagonal step's accumulators
    dkv.append([t.clone() for t in dkv[0]])
    dkv_ref.append([t.clone() for t in dkv_ref[0]])
    kw = dict(diagonal=False, first=False, q_segs=qs, k_segs=ps)
    rf.ring_bwd_dkv(q, k1, v1, o, do, lse, *dkv[2], **kw)
    rf.ring_dkv_step_reference(f(q), f(k1), f(v1), f(o), f(do), lse, *dkv_ref[2], **kw)
    assert _rel(dq, dq_ref) <= 2e-2
    for got, want in zip(sum(dkv, []), sum(dkv_ref, [])):
        assert _rel(got, want) <= 2e-2
    assert rf.LAUNCHES == {"ring_fwd": 3, "ring_bwd_dq": 2, "ring_bwd_dkv": 3}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("c,packed", [(256, False), (200, True)])
def test_step_kernels_match_plain_versions(dev, d, c, packed):
    _check_steps(dev, 2, c, 4, 2, d, packed)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("c,packed", [(1000, True), (2112, False)])
def test_step_kernels_at_tile_edges(dev, d, group, c, packed):
    """Chunks that end inside a 128-row tile (1000 = 7 x 128 + 104,
    2112 = 16 x 128 + 64), GQA groups of 1 and 4; with ``packed`` a
    segment crosses the chunk boundary."""
    _check_steps(dev, 1, c, 4, 4 // group, d, packed)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("c", [200, 1000, 2112])
@pytest.mark.parametrize("packed", [False, True])
def test_dq_kernel_step_by_step(dev, d, c, packed):
    """dQ alone, held to its plain version after each step: the diagonal
    stored (``first``), then a past step added to it. C is no multiple of
    the 128-row q tile (TMA's zero fill, the row guard of the store); with
    ``packed`` a segment crosses the chunk boundary."""
    b, h, kh = 1, 4, 2
    q, do, ((k0, v0), (k1, v1)), (qs, ps) = _chunks(dev, b, c, h, kh, d, packed, seed=4)
    f = lambda t: t.float()  # noqa: E731
    # O and the LSE of both steps, from the plain version
    acc, m, l, o, lse = _state(b, c, h, d, dev)
    o32 = torch.empty(b, c, h, d, device=dev)
    rf.ring_fwd_step_reference(f(q), f(k0), f(v0), acc, m, l, o32, lse, diagonal=True, first=True,
                               finalize_step=False, q_segs=qs, k_segs=qs)
    rf.ring_fwd_step_reference(f(q), f(k1), f(v1), acc, m, l, o32, lse, diagonal=False, first=False,
                               finalize_step=True, q_segs=qs, k_segs=ps)
    o = o32.to(torch.bfloat16)
    rf.reset_launches()
    dq, dq_ref = (torch.full((b, c, h, d), float("nan"), device=dev) for _ in range(2))
    for i, (k, v, kseg, diagonal) in enumerate(((k0, v0, qs, True), (k1, v1, ps, False))):
        kw = dict(diagonal=diagonal, first=i == 0, q_segs=qs, k_segs=kseg)
        rf.ring_bwd_dq(q, k, v, o, do, lse, dq, **kw)
        rf.ring_dq_step_reference(f(q), f(k), f(v), f(o), f(do), lse, dq_ref, **kw)
        assert bool(torch.isfinite(dq).all())
        assert _rel(dq, dq_ref) <= 2e-2, ("diagonal", "past")[i]
    assert rf.LAUNCHES == {"ring_fwd": 0, "ring_bwd_dq": 2, "ring_bwd_dkv": 0}


@pytest.mark.parametrize("d", [64, 128])
def test_dq_of_a_row_that_sees_no_key(dev, d):
    """A past step whose KV chunk holds none of some q rows' segment: the
    forward gives those rows LSE = +inf, and their dQ must come out 0 and
    finite (P = 0 there), the other rows as the plain version."""
    b, c, h, kh = 1, 1000, 4, 2
    q, do, (_, (k, v)), _ = _chunks(dev, b, c, h, kh, d, False, seed=5)
    qs = (torch.arange(c, device=dev) >= 600).int()[None].contiguous()  # rows 600.. are segment 1
    ks = torch.zeros(b, c, dtype=torch.int32, device=dev)  # the KV chunk is all segment 0
    kw = dict(diagonal=False, first=True, q_segs=qs, k_segs=ks)
    rf.reset_launches()
    acc, m, l, o, lse = _state(b, c, h, d, dev)
    rf.ring_fwd(q, k, v, acc, m, l, o, lse, finalize_step=True, **kw)
    assert bool(torch.isinf(lse[..., 600:]).all()) and bool(torch.isfinite(lse[..., :600]).all())
    dq = torch.full((b, c, h, d), float("nan"), device=dev)
    rf.ring_bwd_dq(q, k, v, o, do, lse, dq, **kw)
    dq_ref = torch.empty_like(dq)
    f = lambda t: t.float()  # noqa: E731
    rf.ring_dq_step_reference(f(q), f(k), f(v), f(o), f(do), lse, dq_ref, **kw)
    assert bool(torch.isfinite(dq).all())
    assert bool((dq[:, 600:] == 0).all())
    assert _rel(dq[:, :600], dq_ref[:, :600]) <= 2e-2
    assert rf.LAUNCHES == {"ring_fwd": 1, "ring_bwd_dq": 1, "ring_bwd_dkv": 0}


@pytest.mark.parametrize("causal", [True, False])
def test_local_ring_goes_through_the_kernels(dev, causal):
    n, b, s, h, kh, d = 4, 1, 512, 8, 2, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(b, s, x, d, generator=gen, device=dev).to(torch.bfloat16)
                   for x in (h, kh, kh, h))
    rf.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ring_attention(*leaves, ring=LocalRing(n), causal=causal).backward(do)
    steps = n * (n + 1) // 2 if causal else n * n
    assert rf.LAUNCHES == {"ring_fwd": steps, "ring_bwd_dq": steps, "ring_bwd_dkv": steps}
    ref = [t.float().cpu().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(*ref, ring=LocalRing(n), causal=causal)  # plain versions, fp32
    out.backward(do.float().cpu())
    for got, want in zip(leaves, ref):
        assert _rel(got.grad.cpu(), want.grad) <= 2e-2


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "state"])
def test_unsupported_calls_raise(dev, bad):
    d = 96 if bad == "head_dim" else 64
    dt = torch.float16 if bad == "dtype" else torch.bfloat16
    q = torch.zeros(1, 64, 2, d, device=dev, dtype=dt)
    k = torch.zeros(1, 64, 1, d, device=dev, dtype=dt)
    acc, m, l, o, lse = _state(1, 64, 2, d, dev)
    if bad == "state":
        m = torch.empty(1, 64, 2, device=dev)  # [B, C, H], not [B, H, C]
    with pytest.raises(ValueError):
        rf.ring_fwd(q, k, k, acc, m, l, o.to(dt), lse, diagonal=True, first=True, finalize_step=False)
