"""Ulysses sequence parallelism: an all-to-all between sequence and heads.

Counterpart of :mod:`maggy_tpu.parallel.ulysses`. Each rank of the ``seq``
axis holds one contiguous chunk of the sequence, q ``[B, C, H, D]`` (C =
S/n). One all-to-all (``all_to_all_single`` over the axis' process group)
re-shards q, k and v to heads: the full sequence and ``H/n`` heads a
rank; attention runs locally with any kernel, and the inverse all-to-all
brings the output back to the rank's chunk of the sequence. The
backward of each all-to-all is the inverse all-to-all of the gradient.

The rules are JAX's: GQA KV heads are repeated up to the query heads when
n does not divide their count; n must divide the query heads (at the
tp-local count under tensor parallelism), else ``ValueError`` ("use ring
attention instead"); packed segment ids are all-gathered to full length,
since head-parallel attention sees the whole sequence.

The local attention is the port's flash attention by default
(:func:`maggy_tpu_torch.ops.flash.flash_attention`: the hand-written
kernels on CUDA tensors at ``H/n`` heads over the full sequence, their
plain versions on CPU tensors); ``attn_fn`` replaces it. JAX's default is
``blockwise_attention``, which computes the same function.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from maggy_tpu_torch.ops.attention import repeat_kv
from maggy_tpu_torch.parallel.spec import AXIS_SEQ


def _exchange(x: torch.Tensor, group, to_heads: bool) -> torch.Tensor:
    """One all-to-all over ``group`` (n ranks): ``[B, C, H, D]`` (a chunk of
    the sequence, every head) to ``[B, n*C, H/n, D]`` (the whole sequence,
    this rank's heads) when ``to_heads``, else back."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if to_heads:
        b, c, h, d = x.shape
        send = x.reshape(b, c, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()  # by destination's heads
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * c, h // n, d)  # sources are sequence chunks
    b, s, hl, d = x.shape
    c = s // n
    send = x.reshape(b, n, c, hl, d).permute(1, 0, 2, 3, 4).contiguous()  # by destination's chunk
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, c, n * hl, d)  # sources are head groups


class _AllToAll(torch.autograd.Function):
    """The all-to-all as a differentiable op: its backward is the inverse
    all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return _exchange(x, group, to_heads)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, not ctx.to_heads), None, None


def _gather_segments(seg: torch.Tensor, group) -> torch.Tensor:
    """The full ``[B, S]`` segment ids from every rank's ``[B, C]`` chunk."""
    import torch.distributed as dist

    parts = [torch.empty_like(seg) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, seg.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _seq_group(mesh, axis_name: str):
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.get_group(axis_name)
    raise TypeError(f"ulysses_attention takes a DeviceMesh with a {axis_name!r} axis, got {type(mesh).__name__}")


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    causal: bool = True,
    axis_name: str = AXIS_SEQ,
    attn_fn: Optional[Callable] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ulysses attention over ``mesh``'s ``axis_name`` axis: q ``[B, C, H, D]``
    and k/v ``[B, C, Kh, D]`` are this rank's chunk of the sequence (chunk
    r of n for the axis' rank r), ``segment_ids`` ``[B, C]`` its packed
    segment ids; returns this rank's chunk of the output. Differentiable."""
    import torch.distributed as dist

    group = _seq_group(mesh, axis_name)
    n = dist.get_world_size(group)
    h, kh = q.shape[2], k.shape[2]
    if n > 1 and kh % n != 0:
        # broadcast GQA heads so the all-to-all can split them
        k, v = repeat_kv(k, h), repeat_kv(v, h)
    if attn_fn is None:
        from maggy_tpu_torch.ops.flash import flash_attention as attn_fn
    if n == 1:
        return attn_fn(q, k, v, causal=causal, segment_ids=segment_ids)
    if h % n != 0:
        raise ValueError(
            f"Ulysses needs the seq-axis size ({n}) to divide the head count ({h}); use ring attention instead."
        )
    qh, kh_, vh = (_AllToAll.apply(t, group, True) for t in (q, k, v))
    seg = None if segment_ids is None else _gather_segments(segment_ids.to(torch.int32), group)
    out = attn_fn(qh, kh_, vh, causal=causal, segment_ids=seg)
    return _AllToAll.apply(out, group, False)


def make_ulysses_attention(mesh, axis_name: str = AXIS_SEQ, attn_fn: Optional[Callable] = None):
    """An ``attention_fn`` for ``DecoderConfig``: Ulysses attention over
    ``mesh``'s ``axis_name`` axis, with the signature of
    ``default_attention``."""
    _seq_group(mesh, axis_name)  # a mesh without the axis raises here

    def attn(q, k, v, *, causal: bool = True, segment_ids=None):
        return ulysses_attention(q, k, v, mesh=mesh, causal=causal, axis_name=axis_name, attn_fn=attn_fn,
                                 segment_ids=segment_ids)

    return attn
