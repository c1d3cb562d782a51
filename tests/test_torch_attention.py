"""The port's online-softmax substrate against the JAX package's.

Same fp32 inputs, drawn with numpy, through ``maggy_tpu.ops.attention`` and
``maggy_tpu_torch.ops.attention``. Tolerance 2e-5 absolute: both compute in
fp32, and only the order of the sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.ops import attention as jattn
from maggy_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)
ATOL = 2e-5


def _qkv(b=2, s=48, h=4, kh=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))
    )


def _segments(b, s, seed=1):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(1, s, (b, 2)), axis=1)
    pos = np.arange(s)[None, :]
    return ((pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:]).astype(np.int32))


def test_repeat_kv_matches():
    _, k, _ = _qkv()
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(k), 4).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(k), 4)),
    )


@pytest.mark.parametrize("masked", [False, True])
def test_online_block_update_matches(masked):
    rng = np.random.default_rng(3)
    b, q, kb, h, d = 2, 8, 16, 4, 16
    qv = rng.standard_normal((b, q, h, d)).astype(np.float32)
    kv = rng.standard_normal((b, kb, h, d)).astype(np.float32)
    vv = rng.standard_normal((b, kb, h, d)).astype(np.float32)
    mask = rng.random((b, 1, q, kb)) > 0.3 if masked else None
    mask_np = None if mask is None else mask
    carry_np = (
        rng.standard_normal((b, h, q, d)).astype(np.float32),
        rng.standard_normal((b, h, q)).astype(np.float32),
        rng.random((b, h, q)).astype(np.float32) + 0.5,
    )
    out_j = jattn.online_block_update(
        tuple(jnp.asarray(c) for c in carry_np), jnp.asarray(qv), jnp.asarray(kv),
        jnp.asarray(vv), None if mask_np is None else jnp.asarray(mask_np), 0.25,
    )
    out_t = tattn.online_block_update(
        tuple(torch.from_numpy(c) for c in carry_np), torch.from_numpy(qv),
        torch.from_numpy(kv), torch.from_numpy(vv),
        None if mask_np is None else torch.from_numpy(mask_np), 0.25,
    )
    for a, bt in zip(out_j, out_t):
        np.testing.assert_allclose(bt.numpy(), np.asarray(a), atol=ATOL, rtol=1e-5)


def test_init_carry_and_finalize_match():
    acc, m, l = tattn.init_carry(2, 3, 5, 4)
    ja, jm, jl = jattn.init_carry(2, 3, 5, 4)
    for a, b in ((acc, ja), (m, jm), (l, jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(4)
    acc_np = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    l_np = rng.random((2, 3, 5)).astype(np.float32)
    l_np[0, 0, 0] = 0.0  # an empty row finalizes to 0
    np.testing.assert_allclose(
        tattn.finalize(torch.from_numpy(acc_np), torch.from_numpy(l_np), torch.float32).numpy(),
        np.asarray(jattn.finalize(jnp.asarray(acc_np), jnp.asarray(l_np), jnp.float32)),
        atol=ATOL,
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("block_k", [16, 20])
def test_blockwise_attention_matches(causal, segmented, block_k):
    q, k, v = _qkv()
    segs = _segments(2, q.shape[1]) if segmented else None
    ref = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if segs is None else jnp.asarray(segs), block_k=block_k,
    )
    out = tattn.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        segment_ids=None if segs is None else torch.from_numpy(segs), block_k=block_k,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
