"""Ring attention's per-step compute: forward, dQ and dK/dV of one chunk pair.

Counterpart of the arithmetic of :mod:`maggy_tpu.ops.ring_flash`. There one
Pallas kernel per direction did both the compute and the KV rotation (an
in-kernel RDMA to the next chip). Here the two are split: these step
functions do all the arithmetic of one ring step on one device, and a ring in
:mod:`maggy_tpu_torch.parallel.ringattention` moves the chunks between steps
(NCCL outside the kernels, or index arithmetic within one process).

Three hand-written CUDA kernels (``maggy_tpu_torch/csrc/``) replace the two
Pallas kernels:

* ``ring_fwd`` replaces ``_ring_kernel``'s compute: the online-softmax
  update of the local q chunk against the visiting KV chunk, with the fp32
  state (acc, m, l) carried in device memory from step to step, and on the
  last step O and the LSE instead;
* ``ring_bwd_dq`` and ``ring_bwd_dkv`` replace ``_ring_bwd_kernel``'s
  compute: dQ accumulated locally in fp32, and dK/dV folded into the fp32
  accumulators of the visiting chunk.

The same kernels serve :mod:`maggy_tpu_torch.ops.flash`: flash attention
over a whole sequence is the one-step ring, its outputs written in bf16.

Every chunk has the same length C, so a step is one of three cases, decided
by the caller: the diagonal (the chunk's own KV: causal with q and k
aligned), a past chunk (no mask) or a future chunk (skipped, no launch).
``diagonal`` is the only mask flag the steps take.

Each kernel has a plain PyTorch version beside it (``*_reference``) with
the same arguments and the same in-place effect. :func:`step_functions`
picks the plain versions for CPU tensors and the kernels for CUDA tensors;
a CUDA tensor the kernels cannot take raises. Nothing falls back.

Layouts: q/o/dO ``[B, C, H, D]``, k/v ``[B, C, Kh, D]`` (views with strides
are fine); acc and dq ``[B, C, H, D]`` fp32, dk/dv ``[B, C, Kh, D]`` fp32;
m, l and the LSE ``[B, H, C]`` fp32 with a unit last stride and one stride
pair between them; segment ids ``[B, C]`` int32, one array for the q chunk
and one for the KV chunk.
"""

from __future__ import annotations

import torch

from maggy_tpu_torch.ops.attention import finalize, init_carry, online_block_update, repeat_kv
from maggy_tpu_torch.ops import _build
from maggy_tpu_torch.ops.flash import (
    KERNEL_DTYPE,
    KERNEL_HEAD_DIMS,
    _on_cpu,
    _operand,
    _raise_on,
    _segs_args,
    _stream,
    _strides,
)

# Kernel launches since the last reset_launches(); each wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"ring_fwd": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def _step_mask(q, diagonal, q_segs, k_segs):
    """Attend mask [B|1, 1, C, C] of one step, or None when all pairs attend."""
    c = q.shape[1]
    mask = None
    if diagonal:
        mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()[None, None]
    if q_segs is not None:
        seg = (q_segs[:, :, None] == k_segs[:, None, :])[:, None]
        mask = seg if mask is None else (mask & seg)
    return mask


def ring_fwd_step_reference(q, k, v, acc, m, l, o, lse, *, diagonal, first, finalize_step,
                            q_segs=None, k_segs=None):
    """Plain version of ``ring_fwd``: one online-softmax update of the q
    chunk against the visiting KV chunk. The state (acc, m, l) starts fresh
    when ``first``, else is read; it is written back in place, or on the
    ``finalize_step`` O (q's dtype) and the LSE (+inf where a row saw no key)
    are written instead. Returns what it wrote."""
    b, c, h, d = q.shape
    if first:
        carry = init_carry(b, h, c, d, device=q.device)
    else:
        carry = (acc.transpose(1, 2), m, l)
    mask = _step_mask(q, diagonal, q_segs, k_segs)
    acc_n, m_n, l_n = online_block_update(
        carry, q, repeat_kv(k, h), repeat_kv(v, h), mask, 1.0 / d**0.5
    )
    if finalize_step:
        o.copy_(finalize(acc_n, l_n, o.dtype))
        lse.copy_(torch.where(
            l_n > 0, m_n + torch.log(torch.clamp(l_n, min=1e-30)),
            torch.full_like(l_n, float("inf")),
        ))
        return o, lse
    acc.copy_(acc_n.transpose(1, 2))
    m.copy_(m_n)
    l.copy_(l_n)
    return acc, m, l


def _probs_ds(q, k, v, o, do, lse, diagonal, q_segs, k_segs):
    """P = exp(s - lse) with the step's mask, and dS = P (dP - delta) scale,
    both fp32 [B, H, C, C]; delta = rowsum(dO * O) as ``_ring_bwd_kernel``."""
    h, d = q.shape[2], q.shape[3]
    scale = 1.0 / d**0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), repeat_kv(k, h).float()) * scale
    p = torch.exp(s - lse[..., None])
    mask = _step_mask(q, diagonal, q_segs, k_segs)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), repeat_kv(v, h).float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    return p, p * (dp - delta[..., None]) * scale


def _fold(buf, contrib, first):
    if first:
        buf.copy_(contrib)
    else:
        buf.add_(contrib)


def ring_dq_step_reference(q, k, v, o, do, lse, dq, *, diagonal, first, q_segs=None, k_segs=None):
    """Plain version of ``ring_bwd_dq``: dQ of the q chunk against the
    visiting KV chunk, stored into (``first``) or added to the fp32 ``dq``."""
    _, ds = _probs_ds(q, k, v, o, do, lse, diagonal, q_segs, k_segs)
    contrib = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(k, q.shape[2]).float())
    _fold(dq, contrib, first)
    return dq


def ring_dkv_step_reference(q, k, v, o, do, lse, dk, dv, *, diagonal, first,
                            q_segs=None, k_segs=None):
    """Plain version of ``ring_bwd_dkv``: the visiting chunk's dK/dV from the
    local q chunk, summed over each GQA group in fp32, stored into
    (``first``) or added to the chunk's fp32 accumulators ``dk``, ``dv``."""
    p, ds = _probs_ds(q, k, v, o, do, lse, diagonal, q_segs, k_segs)
    b, c, kh, d = k.shape
    group = q.shape[2] // kh
    dv_c = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).reshape(b, c, kh, group, d).sum(3)
    dk_c = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).reshape(b, c, kh, group, d).sum(3)
    _fold(dk, dk_c, first)
    _fold(dv, dv_c, first)
    return dk, dv


# ------------------------------------------------------------------ kernels


def _check(name, q, k, v, bf16=(), fp32=(), stats=(), q_segs=None, k_segs=None):
    """Raise unless the kernel takes these operands: CUDA, bf16 q/k/v (and
    ``bf16``), fp32 ``fp32`` and ``stats``, whole 16-byte rows, one stride
    pair for the [B, H, C] ``stats``, int32 segment ids for both chunks or
    for neither."""
    tensors = [q, k, v, *bf16, *fp32, *stats] + [t for t in (q_segs, k_segs) if t is not None]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} kernel: a tensor is on {t.device}, not CUDA")
    if any(t.dtype != KERNEL_DTYPE for t in (q, k, v, *bf16)):
        raise ValueError(f"{name} kernel takes bf16 q/k/v/o/dO, got {[t.dtype for t in (q, k, v, *bf16)]}")
    if any(t.dtype != torch.float32 for t in (*fp32, *stats)):
        raise ValueError(f"{name} kernel takes fp32 state and accumulators")
    b, c, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    kh = k.shape[2]
    if tuple(k.shape) != (b, c, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f"{name} kernel: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for t in (*bf16, *fp32):
        if tuple(t.shape) != (b, c, h, d):
            raise ValueError(f"{name} kernel: operand shape {tuple(t.shape)} does not match q {tuple(q.shape)}")
        vec = 8 if t.dtype == KERNEL_DTYPE else 4  # elements in 16 bytes
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: operands need unit last stride and 16-byte rows")
    for t in stats:
        if tuple(t.shape) != (b, h, c) or t.stride() != stats[0].stride() or t.stride(2) != 1:
            raise ValueError(f"{name} kernel: m/l/LSE must be [B, H, C] views with one stride pair")
    if (q_segs is None) != (k_segs is None):
        raise ValueError(f"{name} kernel: segment ids for both chunks or for neither")
    for t in (q_segs, k_segs):
        if t is not None and (tuple(t.shape) != (b, c) or t.dtype != torch.int32 or t.stride(1) != 1):
            raise ValueError(f"{name} kernel: segment ids must be int32 [B, C] with unit last stride")


def ring_fwd(q, k, v, acc, m, l, o, lse, *, diagonal, first, finalize_step, q_segs=None, k_segs=None):
    """The ``ring_fwd`` kernel on CUDA tensors; arguments and effect as
    :func:`ring_fwd_step_reference`."""
    q, k, v = _operand(q), _operand(k), _operand(v)
    _check("ring_fwd", q, k, v, bf16=(o,), fp32=(acc,), stats=(m, l, lse), q_segs=q_segs, k_segs=k_segs)
    b, c, h, d = q.shape
    (qs, ks), (qs_b, ks_b) = _segs_args(q_segs, k_segs)
    rc = _build.kernel("ring_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs, ks,
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, k.shape[2], c, d, int(diagonal), int(first), int(finalize_step), 1.0 / d**0.5,
        *_strides(q), *_strides(k), *_strides(v), *_strides(acc), *_strides(o),
        m.stride(0), m.stride(1), qs_b, ks_b, _stream(q),
    )
    _raise_on(rc, "ring_fwd")
    LAUNCHES["ring_fwd"] += 1
    return (o, lse) if finalize_step else (acc, m, l)


def ring_bwd_dq(q, k, v, o, do, lse, dq, *, diagonal, first, q_segs=None, k_segs=None):
    """The ``ring_bwd_dq`` kernel on CUDA tensors; arguments and effect as
    :func:`ring_dq_step_reference`."""
    q, k, v, o, do = (_operand(t) for t in (q, k, v, o, do))
    _check("ring_bwd_dq", q, k, v, bf16=(o, do), fp32=(dq,), stats=(lse,), q_segs=q_segs, k_segs=k_segs)
    b, c, h, d = q.shape
    (qs, ks), (qs_b, ks_b) = _segs_args(q_segs, k_segs)
    rc = _build.kernel("ring_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), qs, ks, dq.data_ptr(),
        b, h, k.shape[2], c, d, int(diagonal), int(first), 1, 1.0 / d**0.5,  # fp32 accumulators
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), *_strides(do), *_strides(dq),
        lse.stride(0), lse.stride(1), qs_b, ks_b, _stream(q),
    )
    _raise_on(rc, "ring_bwd_dq")
    LAUNCHES["ring_bwd_dq"] += 1
    return dq


def ring_bwd_dkv(q, k, v, o, do, lse, dk, dv, *, diagonal, first, q_segs=None, k_segs=None):
    """The ``ring_bwd_dkv`` kernel on CUDA tensors; arguments and effect as
    :func:`ring_dkv_step_reference`."""
    q, k, v, o, do = (_operand(t) for t in (q, k, v, o, do))
    _check("ring_bwd_dkv", q, k, v, bf16=(o, do), fp32=(), stats=(lse,), q_segs=q_segs, k_segs=k_segs)
    _check("ring_bwd_dkv", k, k, v, fp32=(dk, dv))  # accumulators have k's shape
    b, c, h, d = q.shape
    delta = torch.empty((b, h, c), dtype=torch.float32, device=q.device)  # rowsum(dO * O), filled by the kernel
    (qs, ks), (qs_b, ks_b) = _segs_args(q_segs, k_segs)
    rc = _build.kernel("ring_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), qs, ks, dk.data_ptr(), dv.data_ptr(),
        b, h, k.shape[2], c, d, int(diagonal), int(first), 1, 1.0 / d**0.5,  # fp32 accumulators
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), *_strides(do),
        *_strides(dk), *_strides(dv),
        lse.stride(0), lse.stride(1), qs_b, ks_b, _stream(q),
    )
    _raise_on(rc, "ring_bwd_dkv")
    LAUNCHES["ring_bwd_dkv"] += 1
    return dk, dv


# ----------------------------------------------------------------- dispatch


def step_functions(t: torch.Tensor):
    """``(fwd, dq, dkv)`` step functions for tensors like ``t``: the plain
    versions on the CPU, the kernels on CUDA."""
    if _on_cpu(t):
        return ring_fwd_step_reference, ring_dq_step_reference, ring_dkv_step_reference
    return ring_fwd, ring_bwd_dq, ring_bwd_dkv
