"""Blockwise attention with online softmax: the plain PyTorch substrate.

Counterpart of :mod:`maggy_tpu.ops.attention`. KV is processed in blocks with
running (max, denominator, accumulator) statistics, the FlashAttention
recurrence, so the [S, S] score matrix never exists. The flash kernels in
:mod:`maggy_tpu_torch.ops.flash` compute the same math and are held against
these functions.

All statistics are fp32 whatever the input dtype; tensors keep the
``[B, S, H, D]`` layout of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: broadcast KV heads ``[B, S, Kh, D]`` up to the query head count."""
    kh = k.shape[2]
    if kh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kh, dim=2)


def online_block_update(
    carry: Carry,
    q: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> Carry:
    """One online-softmax step over a KV block.

    carry = (acc [B,H,Q,D] fp32, m [B,H,Q] fp32 running max,
             l [B,H,Q] fp32 running denominator); q [B,Q,H,D];
    k_blk/v_blk [B,Kb,H,D]; mask broadcastable to [B,H,Q,Kb] (True = attend).
    """
    acc, m, l = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    return acc * corr[..., None] + pv, m_new, l_new


def finalize(acc: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    """acc [B,H,Q,D] / l → [B,Q,H,D] in ``dtype``; empty rows give 0."""
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


def init_carry(b: int, h: int, q: int, d: int, device=None) -> Carry:
    return (
        torch.zeros((b, h, q, d), dtype=torch.float32, device=device),
        torch.full((b, h, q), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((b, h, q), dtype=torch.float32, device=device),
    )


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Memory-efficient attention: q [B,S,H,D], k/v [B,S,Kh,D] (GQA broadcast
    internally) → [B,S,H,D]; never holds more than [B,H,S,block_k] scores.
    A ragged last block is masked rather than padded."""
    b, sq, h, d = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    sk = k.shape[1]
    block_k = min(block_k, sk)
    scale = 1.0 / (d**0.5)
    q_pos = torch.arange(sq, device=q.device)
    carry = init_carry(b, h, sq, d, device=q.device)
    for start in range(0, sk, block_k):
        stop = min(start + block_k, sk)
        kpos = torch.arange(start, stop, device=q.device)
        mask = None
        if causal:
            mask = (q_pos[:, None] >= kpos[None, :])[None, None]
        if segment_ids is not None:
            smask = (
                segment_ids[:, :sq, None] == segment_ids[:, None, start:stop]
            )[:, None]
            mask = smask if mask is None else (mask & smask)
        carry = online_block_update(
            carry, q, k[:, start:stop], v[:, start:stop], mask, scale
        )
    acc, _, l = carry
    return finalize(acc, l, q.dtype)
