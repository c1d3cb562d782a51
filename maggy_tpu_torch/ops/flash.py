"""Flash attention, forward and backward, for training.

Counterpart of :mod:`maggy_tpu.ops.flash`. Three wrappers launch the
hand-written CUDA kernels (``maggy_tpu_torch/csrc/``) that replace the three
Pallas kernels there. Flash attention over a whole sequence is one step of
ring attention (first and last step at once, the causal diagonal), so the
wrappers launch the ring-step kernels of :mod:`maggy_tpu_torch.ops.ring_flash`
with their outputs written in bf16 and no state carried:

* ``flash_fwd`` (``csrc/ring_fwd.cu``) replaces ``_fwd_kernel``: O and the
  per-row LSE;
* ``flash_bwd_dq`` (``csrc/ring_bwd_dq.cu``) replaces ``_dq_kernel``: dQ;
* ``flash_bwd_dkv`` (``csrc/ring_bwd_dkv.cu``) replaces ``_dkv_kernel`` and
  the GQA group sum of ``_flash_core``'s backward: dK and dV per KV head.

Each kernel has a plain PyTorch version beside it (``flash_fwd_reference``,
``flash_dq_reference``, ``flash_dkv_reference``) computing the same function
the same way: P is recomputed from the saved LSE and ``delta = rowsum(dO*O)``
from O and dO, as ``_recompute_p_ds`` does. A tensor on the CPU goes to the
plain version; a CUDA tensor launches the kernel or raises. Nothing falls
back from one to the other.

Layouts are the JAX package's: q/o ``[B, S, H, D]``, k/v ``[B, S, Kh, D]``
(self-attention: q and k/v have the same length), LSE ``[B, H, S]`` fp32,
segment ids ``[B, S]``. The kernels read q/k/v through
their strides and mask ragged sequence edges themselves, so there is no
alignment fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from maggy_tpu_torch.ops import _build
from maggy_tpu_torch.ops.attention import NEG_INF, repeat_kv

# Kernel launches since the last reset_launches(); each wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

KERNEL_DTYPE = torch.bfloat16
KERNEL_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def _masked_scores(q, k, causal, segment_ids):
    """fp32 scaled scores [B,H,Sq,Sk] and the attend mask (or None)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = repeat_kv(k, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d**0.5)
    mask = None
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = (qi >= ki)[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else (mask & seg)
    return s, mask


def _probs(q, k, lse, causal, segment_ids):
    """P = exp(s - lse) with the forward's mask re-applied (``_recompute_p_ds``)."""
    s, mask = _masked_scores(q, k, causal, segment_ids)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    return p


def flash_fwd_reference(q, k, v, *, causal=True, segment_ids=None):
    """Plain version of the forward kernel: (O [B,S,H,D] in q's dtype,
    LSE [B,H,S] fp32, +inf where a row sees no key)."""
    h = q.shape[2]
    s, mask = _masked_scores(q, k, causal, segment_ids)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, repeat_kv(v, h).float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(
        l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
        torch.full_like(l, float("inf")),
    )
    return o.transpose(1, 2).to(q.dtype), lse


def _ds(q, k, v, o, do, lse, causal, segment_ids):
    p = _probs(q, k, lse, causal, segment_ids)
    h = q.shape[2]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), repeat_kv(v, h).float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B,H,S]
    return p, p * (dp - delta[..., None]) * (1.0 / q.shape[-1] ** 0.5)


def flash_dq_reference(q, k, v, o, do, lse, *, causal=True, segment_ids=None):
    """Plain version of the dQ kernel: dQ [B,S,H,D] in q's dtype."""
    _, ds = _ds(q, k, v, o, do, lse, causal, segment_ids)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(k, q.shape[2]).float())
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, o, do, lse, *, causal=True, segment_ids=None):
    """Plain version of the dK/dV kernel: per-q-head grads summed over each
    GQA group in fp32 → (dK, dV) [B,S,Kh,D] in k's and v's dtypes."""
    p, ds = _ds(q, k, v, o, do, lse, causal, segment_ids)
    b, sk, kh, d = k.shape
    group = q.shape[2] // kh
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, sk, kh, group, d).sum(3)
    dv = dv.reshape(b, sk, kh, group, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels


def _strided_ok(t: torch.Tensor) -> bool:
    # 16-byte vector loads: last dim contiguous, other strides whole vectors
    return (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )


def _operand(t: torch.Tensor) -> torch.Tensor:
    return t if _strided_ok(t) else t.contiguous()


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q, k, v, segment_ids):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash kernel: {name} is on {t.device}, not CUDA")
    if q.dtype != KERNEL_DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash kernel takes bf16 q/k/v, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, sq, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if k.shape[0] != b or k.shape[1] != sq or k.shape[3] != d or v.shape != k.shape or h % k.shape[2]:
        raise ValueError(f"flash kernel: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, sq):
        raise ValueError("segment_ids must be [B, S]")


def _segs(segment_ids):
    if segment_ids is None:
        return None
    return segment_ids.to(torch.int32).contiguous()


def _raise_on(rc: int, name: str) -> None:
    if rc == -1:
        raise ValueError(f"{name}: head_dim not supported by the kernel")
    if rc in (-2, -3):
        raise RuntimeError(f"{name}: the driver cannot make a TMA tensor map for these operands (code {rc})")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _segs_args(q_segs, k_segs):
    """The kernels' segment-id pointers and batch strides, for the q and the
    KV sequence (self-attention passes one array twice)."""
    if q_segs is None:
        return (None, None), (0, 0)
    return (q_segs.data_ptr(), k_segs.data_ptr()), (q_segs.stride(0), k_segs.stride(0))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, causal=True, segment_ids=None):
    """Forward kernel: (O [B,S,H,D], LSE [B,H,S] fp32) for CUDA q/k/v."""
    _check(q, k, v, segment_ids)
    q, k, v = _operand(q), _operand(k), _operand(v)
    segs = _segs(segment_ids)
    b, s, h, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    (qs, ks), (qs_b, ks_b) = _segs_args(segs, segs)
    # one step that is first and last: no running state (acc, m, l) in memory
    rc = _build.kernel("ring_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs, ks,
        None, None, None, o.data_ptr(), lse.data_ptr(),
        b, h, k.shape[2], s, d, int(causal), 1, 1, 1.0 / d**0.5,
        *_strides(q), *_strides(k), *_strides(v), 0, 0, 0, *_strides(o),
        lse.stride(0), lse.stride(1), qs_b, ks_b,
        _stream(q),
    )
    _raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_operands(q, k, v, o, do, lse, segment_ids):
    _check(q, k, v, segment_ids)
    q, k, v, o, do = (_operand(t) for t in (q, k, v, o, do))
    return q, k, v, o, do, lse.float().contiguous(), _segs(segment_ids)


def flash_bwd_dq(q, k, v, o, do, lse, *, causal=True, segment_ids=None):
    """dQ kernel: dQ [B,S,H,D] for CUDA tensors."""
    q, k, v, o, do, lse, segs = _bwd_operands(q, k, v, o, do, lse, segment_ids)
    b, s, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    (qs, ks), (qs_b, ks_b) = _segs_args(segs, segs)
    rc = _build.kernel("ring_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), qs, ks, dq.data_ptr(),
        b, h, k.shape[2], s, d, int(causal), 1, 0, 1.0 / d**0.5,  # first, stored in bf16
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), *_strides(do), *_strides(dq),
        lse.stride(0), lse.stride(1), qs_b, ks_b,
        _stream(q),
    )
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, *, causal=True, segment_ids=None):
    """dK/dV kernel: (dK, dV) [B,S,Kh,D] per KV head for CUDA tensors."""
    q, k, v, o, do, lse, segs = _bwd_operands(q, k, v, o, do, lse, segment_ids)
    b, s, h, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)  # rowsum(dO * O), filled by the kernel
    (qs, ks), (qs_b, ks_b) = _segs_args(segs, segs)
    rc = _build.kernel("ring_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), qs, ks, dk.data_ptr(), dv.data_ptr(),
        b, h, k.shape[2], s, d, int(causal), 1, 0, 1.0 / d**0.5,  # first, stored in bf16
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), *_strides(do),
        *_strides(dk), *_strides(dv), lse.stride(0), lse.stride(1), qs_b, ks_b,
        _stream(q),
    )
    _raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ----------------------------------------------------------------- dispatch


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, not {t.device}")


class _FlashAttention(torch.autograd.Function):
    """Mirror of ``_flash_core``'s custom VJP: the forward saves O and the
    LSE; the backward recomputes P from them (no [S, S] residual)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal):
        fwd = flash_fwd_reference if _on_cpu(q) else flash_fwd
        o, lse = fwd(q, k, v, causal=causal, segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        if _on_cpu(q):
            dq_fn, dkv_fn = flash_dq_reference, flash_dkv_reference
        else:
            dq_fn, dkv_fn = flash_bwd_dq, flash_bwd_dkv
        args = (q, k, v, o, do.to(o.dtype), lse)
        kw = dict(causal=ctx.causal, segment_ids=segment_ids)
        dq = dq_fn(*args, **kw)
        dk, dv = dkv_fn(*args, **kw)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,S,Kh,D] → [B,S,H,D]; differentiable. CUDA tensors
    run the three kernels (bf16, head_dim 64 or 128, else ValueError);
    CPU tensors run their plain versions."""
    return _FlashAttention.apply(q, k, v, segment_ids, causal)
