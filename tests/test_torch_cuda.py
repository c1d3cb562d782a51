"""The flash kernels on the card against their plain versions.

These need a CUDA card and the CUDA toolkit: they skip elsewhere. On the
card, run them without the JAX package's test configuration:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Inputs are bf16 from a seeded generator; the plain versions run in fp32 from
the same inputs. Tolerances: O 2e-2 absolute (one bf16 rounding of values
below 8) and 1e-2 relative L2 (the rounding noise is about 2e-3, so an error
spread thinly over many rows shows there), the LSE 1e-3 absolute, dq/dk/dv 2e-2
relative L2 (P and dS are rounded to bf16 before their products, as on the
TPU).
"""

import pytest
import torch

from maggy_tpu_torch.ops import flash
from maggy_tpu_torch.ops.attention import blockwise_attention

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, b, s, h, kh, d, packed, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    segs = None
    if packed:
        segs = (torch.arange(s, device=dev) >= s // 3).int() + (torch.arange(s, device=dev) >= s // 2).int()
        segs = segs[None].repeat(b, 1)
    return rand(b, s, h, d), rand(b, s, kh, d), rand(b, s, kh, d), rand(b, s, h, d), segs


def _rel(a, r):
    return float((a.float() - r).norm() / r.norm())


def _check_kernels(dev, b, s, h, kh, d, packed, causal):
    """Forward, dQ and dK/dV, one launch each, against the plain versions."""
    q, k, v, do, segs = _case(dev, b, s, h, kh, d, packed)
    kw = dict(causal=causal, segment_ids=segs)
    f32 = [t.float() for t in (q, k, v)]
    flash.reset_launches()
    o, lse = flash.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash.flash_fwd_reference(*f32, **kw)
    assert float((o.float() - o_ref).abs().max()) <= 2e-2 and _rel(o, o_ref) <= 1e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    dq = flash.flash_bwd_dq(q, k, v, o, do, lse, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, o, do, lse, **kw)
    ref_in = (*f32, o.float(), do.float(), lse)
    dk_ref, dv_ref = flash.flash_dkv_reference(*ref_in, **kw)
    assert _rel(dq, flash.flash_dq_reference(*ref_in, **kw)) <= 2e-2
    assert _rel(dk, dk_ref) <= 2e-2 and _rel(dv, dv_ref) <= 2e-2
    assert flash.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,packed,causal", [(256, False, True), (200, True, True), (130, False, False)])
def test_kernels_match_plain_versions(dev, d, s, packed, causal):
    _check_kernels(dev, 2, s, 4, 2, d, packed, causal)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("s,packed", [(1000, True), (2112, False)])
def test_kernels_at_tile_edges(dev, d, group, s, packed):
    """Sequences that end inside a 128-row tile (1000 = 7 x 128 + 104,
    2112 = 16 x 128 + 64; the forward's q and KV tiles and the dK/dV
    kernel's KV tiles are 128 rows, its q tiles 64), GQA groups of 1 and 4."""
    _check_kernels(dev, 1, s, 4, 4 // group, d, packed, True)


def test_autograd_goes_through_the_kernels(dev):
    q, k, v, do, _ = _case(dev, 1, 192, 8, 2, 128, False, seed=1)
    flash.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash.flash_attention(*leaves).backward(do)
    assert flash.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    blockwise_attention(*ref, causal=True).backward(do.float())  # plain fp32 autograd
    for got, want in zip(leaves, ref):
        assert _rel(got.grad, want.grad) <= 2e-2


def test_strided_inputs_need_no_copy(dev):
    """q/k/v as views of one fused projection, as a model produces them."""
    b, s, h, kh, d = 1, 128, 4, 2, 64
    qkv = torch.randn(b, s, (h + 2 * kh) * d, device=dev, dtype=torch.bfloat16)
    q = qkv[..., : h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + kh) * d].view(b, s, kh, d)
    v = qkv[..., (h + kh) * d:].view(b, s, kh, d)
    assert not q.is_contiguous()
    o, _ = flash.flash_fwd(q, k, v)
    o_ref, _ = flash.flash_fwd_reference(q.float(), k.float(), v.float())
    assert float((o.float() - o_ref).abs().max()) <= 2e-2 and _rel(o, o_ref) <= 1e-2


@pytest.mark.parametrize("bad", ["head_dim", "dtype"])
def test_unsupported_calls_raise(dev, bad):
    d, dtype = (96, torch.bfloat16) if bad == "head_dim" else (64, torch.float16)
    q = torch.zeros(1, 64, 2, d, device=dev, dtype=dtype)
    k = torch.zeros(1, 64, 1, d, device=dev, dtype=dtype)
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, k)
