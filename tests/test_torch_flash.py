"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's ``flash_attention`` runs the plain versions of its
three kernels (``flash_fwd_reference``, ``flash_dq_reference``,
``flash_dkv_reference``); the JAX side runs the Pallas kernels in interpret
mode, as ``tests/test_attention_ops.py`` does. Same fp32 inputs from numpy,
D=128, S=256, blocks of 128, GQA group 2, causal and packed.

Tolerances: O and the LSE 1e-4 absolute, dq/dk/dv 2e-4 absolute with 1e-4
relative. Both sides compute in fp32; the Pallas kernel sums blockwise with
an online rescale and the plain version in one pass, so the results differ
in the last bits of fp32 sums over 256 keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.ops import flash as jflash
from maggy_tpu_torch.ops import attention as tattn
from maggy_tpu_torch.ops import flash as tflash

torch.set_num_threads(2)
B, S, H, KH, D, BLOCK = 1, 256, 4, 2, 128, 128


def _inputs(seed=0, packed=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)  # output cotangent
    segs = None
    if packed:
        cuts = np.sort(rng.choice(np.arange(1, S), size=2, replace=False))
        pos = np.arange(S)[None, :].repeat(B, 0)
        segs = ((pos >= cuts[0]).astype(np.int32) + (pos >= cuts[1]).astype(np.int32))
    return q, k, v, g, segs


def _jax_lse(q, k, v, segs):
    qr = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B * H, S, D)
    kr = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(B * KH, S, D)
    vr = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(B * KH, S, D)
    _, lse = jflash._fwd_call(
        qr, kr, vr, None if segs is None else jnp.asarray(segs),
        causal=True, block_q=BLOCK, block_k=BLOCK, group=H // KH, heads=H,
        interpret=True,
    )
    return np.asarray(lse).reshape(B, H, S)


@pytest.mark.parametrize("packed", [False, True], ids=["causal", "packed"])
def test_flash_matches_pallas_interpret(packed):
    q, k, v, g, segs = _inputs(packed=packed)
    jsegs = None if segs is None else jnp.asarray(segs)

    def jloss(q, k, v):
        o = jflash.flash_attention(
            q, k, v, causal=True, block_q=BLOCK, block_k=BLOCK,
            interpret=True, segment_ids=jsegs,
        )
        return (o * jnp.asarray(g)).sum(), o

    (_, o_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )

    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tsegs = None if segs is None else torch.from_numpy(segs)
    o_t = tflash.flash_attention(qt, kt, vt, causal=True, segment_ids=tsegs)
    (o_t * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=1e-4)
    _, lse_t = tflash.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, segment_ids=tsegs,
    )
    np.testing.assert_allclose(lse_t.numpy(), _jax_lse(q, k, v, segs), atol=1e-4)
    for name, gt, gj in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(
            gt.numpy(), np.asarray(gj), atol=2e-4, rtol=1e-4, err_msg=f"d{name}"
        )


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_agree_with_autograd_of_blockwise(causal):
    """The three plain versions against autograd through the online-softmax
    substrate, with a ragged length and GQA (fp32; 1e-5 absolute)."""
    rng = np.random.default_rng(5)
    s = 37
    q, k, v, g = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for shape in ((2, s, 4, 8), (2, s, 2, 8), (2, s, 2, 8), (2, s, 4, 8))
    )
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.blockwise_attention(*leaves, causal=causal, block_k=16)
    (ref * g).sum().backward()
    o, lse = tflash.flash_fwd_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), atol=1e-5)
    dq = tflash.flash_dq_reference(q, k, v, o, g, lse, causal=causal)
    dk, dv = tflash.flash_dkv_reference(q, k, v, o, g, lse, causal=causal)
    for got, leaf in zip((dq, dk, dv), leaves):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=1e-5)


def test_cpu_tensors_never_count_as_kernel_launches():
    tflash.reset_launches()
    q, k, v, g, _ = _inputs()
    qt = torch.from_numpy(q).requires_grad_(True)
    out = tflash.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v))
    out.sum().backward()
    assert tflash.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _, _ = _inputs()
    with pytest.raises(ValueError, match="not CUDA"):
        tflash.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
