"""Flagship model family: LLaMA-style decoder-only transformer.

Counterpart of :mod:`maggy_tpu.models.transformer`: RMSNorm + RoPE + SwiGLU +
grouped-query attention, bf16 compute over fp32 parameters, LOCO ablation
gates, tied embeddings, logit soft-capping and per-layer rematerialisation
through :func:`torch.utils.checkpoint`; and the KV-cache decode path, dense
or paged, that the serving engine runs.

The decode path. Flax keeps the cache in a mutable ``"cache"`` collection
per layer and selects the path by ``cfg.decode``; here an explicit
:class:`KVCache` is passed to ``Decoder.forward(..., cache=...)``, which then
appends this call's K/V to it in place and attends every query over what is
cached. One module serves a one-row prefill cache and the batch cache
alike. The cache is read in ``decode_chunk``-sized chunks under the
online-softmax recurrence of :mod:`maggy_tpu_torch.ops.attention`, and only
as many chunks as the longest row has written: that count is a host int
(``kv_len``), since reading it from the device would block an asynchronous
decode loop. A bound above the device's is exact (a chunk a row sees no key
of leaves its state bit-identical), one below it is wrong.

Numerics follow flax's: every dense layer casts its input and its fp32
weight to ``cfg.dtype`` and computes there; RMSNorm multiplies its scale in
fp32 before the cast; RoPE runs in fp32; the logits come out of a
``cfg.dtype`` ``lm_head`` and are cast to fp32 only afterwards.

Weights use PyTorch's ``[out, in]`` layout; :mod:`maggy_tpu_torch.convert`
maps a JAX parameter tree onto them. The layers are always a plain module
list: ``scan_layers`` only tells the converter how the JAX tree was laid out.
The residual stream needs no layout constraint on one device, so the JAX
package's ``_constrain_residual`` has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from maggy_tpu_torch.ops import attention as ops_attn
from maggy_tpu_torch.util import resolve_device

# remat policies by name, the JAX package's. "nothing" recomputes the whole
# layer in the backward (minimum memory); "everything" saves it all (no
# recompute). "dots" saves the projections' matmul outputs (JAX's
# dots_with_no_batch_dims_saveable: aten.mm/addmm, not the batched bmm) and
# recomputes the rest, the flash forward included; "dots_attn" also saves
# the flash forward's O and LSE, which the dQ and dK/dV kernels read, so the
# forward kernel runs once per layer. (JAX's "dots_attn" saves only O, so
# its backward still re-runs the Pallas forward for the LSE.)
REMAT_POLICIES = ("nothing", "dots", "dots_attn", "everything")


def _saved_ops(policy: str) -> frozenset:
    """The operators whose outputs a selective-checkpoint policy keeps."""
    dots = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    if policy == "dots_attn":
        from maggy_tpu_torch.ops.flash import flash_forward_op

        dots.add(flash_forward_op._opoverload)
    return frozenset(dots)


def _selective_context(policy: str):
    saved = _saved_ops(policy)

    def keep(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(keep)


def _parse_ablated(ablated, n_layers: int):
    """Component-name grammar for LOCO ablation: "attn" / "mlp" (that
    sublayer in every layer), "layers.<i>" (layer i entirely),
    "layers.<i>.attn" / "layers.<i>.mlp". Returns a [n_layers, 2] float gate
    array (attn, mlp) or None when nothing is ablated. Raises on unknown
    names so typos never silently train the full model."""
    if not ablated:
        return None
    gates = np.ones((n_layers, 2), np.float32)
    for comp in sorted(ablated):
        parts = str(comp).split(".")
        ok = True
        if comp == "attn":
            gates[:, 0] = 0.0
        elif comp == "mlp":
            gates[:, 1] = 0.0
        elif parts[0] == "layers" and len(parts) in (2, 3) and parts[1].isdigit():
            i = int(parts[1])
            if not 0 <= i < n_layers:
                raise ValueError(
                    f"Ablated component {comp!r}: layer index out of range "
                    f"(n_layers={n_layers})"
                )
            if len(parts) == 2:
                gates[i] = 0.0
            elif parts[2] == "attn":
                gates[i, 0] = 0.0
            elif parts[2] == "mlp":
                gates[i, 1] = 0.0
            else:
                ok = False
        else:
            ok = False
        if not ok:
            raise ValueError(
                f"Unknown ablated component {comp!r}; expected 'attn', 'mlp', "
                "'layers.<i>', 'layers.<i>.attn' or 'layers.<i>.mlp'"
            )
    return gates


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1376
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # layout of the JAX parameter tree this config converts from
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "dots_attn"
    logits_softcap: float = 0.0
    tie_embeddings: bool = False
    attention_fn: Optional[Callable] = None
    # decode=True marks a config for the KV-cache path (what selects the
    # path here is the cache passed to Decoder.forward); paged=True (decode
    # only) stores K/V in a pool of num_pages pages of page_size tokens,
    # mapped per row by a page table (see KVCache)
    decode: bool = False
    paged: bool = False
    page_size: int = 64
    num_pages: int = 0
    # KV-cache read chunk, rounded down to a divisor of max_seq_len at use
    decode_chunk: int = 256
    # components gated to zero for LOCO ablation (see _parse_ablated)
    ablated: Any = frozenset()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {sorted(REMAT_POLICIES)}")
        if self.paged:
            if not self.decode:
                raise ValueError("paged=True requires decode=True")
            p = self.page_size
            if p < 1 or (p & (p - 1)):
                raise ValueError(f"page_size must be a power of two, got {p}")
            if self.max_seq_len % p:
                raise ValueError(
                    f"page_size ({p}) must divide max_seq_len ({self.max_seq_len})"
                )
            if self.num_pages < 2:
                raise ValueError(
                    "paged=True needs num_pages >= 2 (page 0 is the reserved "
                    f"scratch page), got {self.num_pages}"
                )
        object.__setattr__(self, "ablated", frozenset(self.ablated))
        _parse_ablated(self.ablated, self.n_layers)  # validate eagerly

    def without(self, components) -> "DecoderConfig":
        """A config whose named components (``_parse_ablated`` grammar) are
        gated out of the forward pass; parameter shapes are unchanged."""
        if isinstance(components, str):
            components = (components,)
        return dataclasses.replace(
            self, ablated=self.ablated | frozenset(components)
        )

    @classmethod
    def llama3_8b(cls, **overrides) -> "DecoderConfig":
        """Llama-3-8B geometry."""
        return cls(
            **{
                **dict(
                    vocab_size=128_256,
                    d_model=4096,
                    n_layers=32,
                    n_heads=32,
                    n_kv_heads=8,
                    d_ff=14_336,
                    rope_theta=500_000.0,
                    max_seq_len=8192,
                    remat=True,
                    remat_policy="nothing",
                ),
                **overrides,
            }
        )

    @classmethod
    def tiny(cls, **overrides) -> "DecoderConfig":
        """Test/debug geometry."""
        return cls(
            **{
                **dict(
                    vocab_size=256,
                    d_model=64,
                    n_layers=2,
                    n_heads=4,
                    n_kv_heads=2,
                    d_ff=128,
                    max_seq_len=128,
                ),
                **overrides,
            }
        )


class Dense(nn.Linear):
    """Bias-free projection computed in ``cfg.dtype``: input and fp32 weight
    are both cast, as flax's ``DenseGeneral(dtype=...)`` does. An
    ``nn.Linear`` (with no bias) so that tensor parallelism's
    ``ColwiseParallel``/``RowwiseParallel`` take it; its weights come from
    ``Decoder.reset_parameters``, never from Linear's own initialiser."""

    def __init__(self, d_in: int, d_out: int, cfg: DecoderConfig, device):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.in_features, self.out_features = d_in, d_out
        self.weight = nn.Parameter(
            torch.empty((d_out, d_in), dtype=cfg.param_dtype, device=device)
        )
        self.register_parameter("bias", None)

    def reset_parameters(self) -> None:
        raise TypeError("Dense weights are drawn by Decoder.reset_parameters(generator)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return F.linear(x.to(dt), self.weight.to(dt))


class RMSNorm(nn.Module):
    def __init__(self, cfg: DecoderConfig, device):
        super().__init__()
        self.cfg = cfg
        self.scale = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.param_dtype, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.cfg.norm_eps)
        return (y * self.scale.float()).to(self.cfg.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding over the last dim of [B, S, H, D] tensors,
    split-halves layout, in fp32 (sin/cos of large angles lose too much
    precision in bf16)."""
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = theta ** (-freq)
    angles = positions.float()[..., None] * inv_freq  # [B, S, half]
    angles = angles[:, :, None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def auto_attention(q, k, v, *, causal: bool = True, segment_ids=None):
    """The flash kernels for CUDA tensors; their plain versions, through the
    same autograd function, for CPU tensors. A CUDA call the kernels cannot
    take raises rather than falling back."""
    from maggy_tpu_torch.ops.flash import flash_attention

    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)


def default_attention(q, k, v, *, causal: bool = True, segment_ids=None):
    """Reference soft-max attention: q [B,S,H,D], k/v [B,S,Kh,D] with GQA
    head-group broadcast. fp32 logits/softmax for stability."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    group = h // kh
    q = q.reshape(b, sq, kh, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    logits = logits / d**0.5
    if causal:
        sk = k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    if segment_ids is not None:
        seg = segment_ids[:, None, None, :, None] == segment_ids[:, None, None, None, :]
        logits = logits.masked_fill(~seg, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = Dense(cfg.d_model, cfg.n_heads * hd, cfg, device)
        self.wk = Dense(cfg.d_model, cfg.n_kv_heads * hd, cfg, device)
        self.wv = Dense(cfg.d_model, cfg.n_kv_heads * hd, cfg, device)
        self.wo = Dense(cfg.n_heads * hd, cfg.d_model, cfg, device)

    def forward(self, x, positions, segment_ids=None, kv=None):
        """``kv``: ``(step, layer)`` on the cache path — the forward's
        :class:`_CacheStep` and this layer's index into its cache. The head
        counts come from the projections' outputs: under tensor
        parallelism each rank holds ``n_heads/tp`` query and
        ``n_kv_heads/tp`` KV heads."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x)
        k = self.wk(x)
        v = self.wv(x)
        q = q.view(b, s, q.shape[-1] // hd, hd)
        k = k.view(b, s, k.shape[-1] // hd, hd)
        v = v.view(b, s, v.shape[-1] // hd, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if kv is not None:
            step, layer = kv
            cached = _paged_cached_attention if step.paged else _cached_attention
            out = cached(step, layer, q, k, v)
        else:
            attn = cfg.attention_fn or auto_attention
            out = attn(q, k, v, causal=True, segment_ids=segment_ids)
        return self.wo(out.reshape(b, s, out.shape[2] * hd))


@dataclasses.dataclass
class KVCache:
    """The decode path's cache for every layer, updated in place by
    ``Decoder.forward(..., cache=...)``; :func:`maggy_tpu_torch.models.
    generate.init_cache` makes one.

    * dense: ``k``/``v`` ``[L, B, max_seq_len, Kh, D]``, one row per batch row;
    * paged: ``k``/``v`` ``[L, num_pages, page_size, Kh, D]``, a pool any row
      may use, and ``pages`` ``[B, max_seq_len/page_size]`` int32, row b's
      logical page j -> physical page. Page 0 is scratch: unassigned entries
      point at it and masked writes land there, never read as valid;
    * both: ``index`` ``[B]`` int32, each row's cache length (its next write
      offset), and, for packed prompts (dense only), ``seg`` ``[B,
      max_seq_len]`` int32, the segment id of every cached position.
    """

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    pages: Optional[torch.Tensor] = None
    seg: Optional[torch.Tensor] = None

    @property
    def paged(self) -> bool:
        return self.pages is not None

    def row(self, b: int) -> "KVCache":
        """Row ``b`` as a one-row cache of views: a forward through it writes
        this cache (the pool itself, in paged mode)."""
        one = slice(b, b + 1)
        if self.paged:
            return KVCache(self.k, self.v, self.index[one], self.pages[one])
        return KVCache(self.k[:, one], self.v[:, one], self.index[one],
                       seg=None if self.seg is None else self.seg[one])


def _read_chunk(decode_chunk: int, s: int) -> int:
    """The cache read chunk: ``decode_chunk`` rounded down to a divisor of
    the cache length ``s`` (a chunk never runs past the end), the whole
    cache for pathological lengths."""
    chunk = min(decode_chunk, s)
    while s % chunk:
        chunk //= 2
    return s if chunk < 16 else chunk


class _CacheStep:
    """What every layer's cache write and read share within one forward,
    computed once: where this forward's K/V land and, for each chunk the
    read covers, its mask (and page ids, paged).

    Clamps reproduce JAX's: a dense row write starts at ``min(index, S - t)``
    (``dynamic_update_slice`` shifts an update to fit), the packed track's
    continuation reads position ``clip(index - 1, 0, S - 1)``, a paged write's
    logical page is clipped to the row's last, and the read covers at most
    the whole cache."""

    def __init__(self, cfg, cache: KVCache, positions, segment_ids, kv_len: Optional[int]):
        b, t = positions.shape
        # the geometry is the cache's own: one module serves any cache
        p = cache.k.shape[2]
        s = cache.pages.shape[1] * p if cache.paged else p
        if t > s:
            raise ValueError(f"{t} tokens do not fit a cache of max_seq_len {s}")
        dev = cache.index.device
        idx = cache.index.long()  # [B] write offsets before this forward
        ar = torch.arange(t, device=dev)
        written = idx + t  # [B] cache lengths after it
        self.paged = cache.paged
        self.k, self.v = cache.k, cache.v
        self.scale = 1.0 / cfg.head_dim**0.5
        chunk = _read_chunk(cfg.decode_chunk, s)
        if kv_len is None:
            kv_len = int(written.max())  # a device read: callers that know it pass it
        w_row = written[:, None, None, None]
        if self.paged:
            if segment_ids is not None or cache.seg is not None:
                raise NotImplementedError("paged decode does not support packed segment_ids")
            max_pages = s // p
            pos_w = idx[:, None] + ar[None, :]
            page_slot = torch.clamp(pos_w // p, 0, max_pages - 1)
            self.write_at = (torch.gather(cache.pages.long(), 1, page_slot), pos_w % p)
            cpp = max(1, chunk // p)  # pages per chunk
            chunk = cpp * p
            n_valid = min(-(-kv_len // chunk), max_pages // cpp)
            self.chunk_pages = [cache.pages[:, ci * cpp:(ci + 1) * cpp].long() for ci in range(n_valid)]
        else:
            start = torch.clamp(idx, 0, s - t)
            self.write_at = (torch.arange(b, device=dev)[:, None].expand(b, t), start[:, None] + ar[None, :])
            n_valid = min(-(-kv_len // chunk), s // chunk)
        self.chunk = chunk
        seg_all = seg_q = None
        if segment_ids is not None or cache.seg is not None:
            # packed: the segment-id track, written once for every layer
            if cache.seg is None:
                cache.seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
            if segment_ids is None:
                # continuation: the new token(s) extend the row's last segment
                last = torch.gather(cache.seg, 1, torch.clamp(idx - 1, 0, s - 1)[:, None])
                seg_q = last.expand(b, t)
            else:
                seg_q = segment_ids.to(torch.int32)
            cache.seg[self.write_at] = seg_q
            seg_all = cache.seg
            qslot = idx[:, None] + ar[None, :]  # a query's own cache slot: the causal clock
        self.masks = []
        for ci in range(n_valid):
            kpos = ci * chunk + torch.arange(chunk, device=dev)
            if seg_all is None:
                # causal over the cache (positions == cache slots here) and
                # only what has been written
                mask = (kpos[None, None, None, :] <= positions[:, None, :, None]) & (kpos < w_row)
            else:
                # packed: causal in cache order, within the query's segment
                seg_c = seg_all[:, ci * chunk:(ci + 1) * chunk]
                mask = ((kpos[None, None, None, :] <= qslot[:, None, :, None]) & (kpos < w_row)
                        & (seg_c[:, None, None, :] == seg_q[:, None, :, None]))
            self.masks.append(mask)


def _cached_attention(step: _CacheStep, layer: int, q, k, v):
    """Incremental decoding over a dense cache (``_cached_attention`` of the
    JAX package): append this call's K/V at each row's own write index, then
    attend its queries over the row's cache in chunks, online softmax across
    chunks. Rows may sit at different positions (slot-based batching)."""
    b, t, kh, hd = k.shape
    h = q.shape[2]
    k_all, v_all = step.k[layer], step.v[layer]
    k_all[step.write_at] = k.to(k_all.dtype)
    v_all[step.write_at] = v.to(v_all.dtype)
    c = step.chunk
    carry = ops_attn.init_carry(b, h, t, hd, device=q.device)
    for ci, mask in enumerate(step.masks):
        k_c, v_c = k_all[:, ci * c:(ci + 1) * c], v_all[:, ci * c:(ci + 1) * c]
        carry = ops_attn.online_block_update(
            carry, q, ops_attn.repeat_kv(k_c, h), ops_attn.repeat_kv(v_c, h), mask, step.scale)
    acc, _, l = carry
    return ops_attn.finalize(acc, l, q.dtype)


def _paged_cached_attention(step: _CacheStep, layer: int, q, k, v):
    """The same over a paged cache (``_paged_cached_attention`` of the JAX
    package): each new token scatters to ``(pages[b, pos // P], pos % P)``;
    each chunk gathers its pages into a contiguous block of the dense path's
    chunk length, so whenever ``page_size`` divides the chunk the result is
    bit-identical to the dense path's."""
    b, t, kh, hd = k.shape
    h = q.shape[2]
    k_pool, v_pool = step.k[layer], step.v[layer]
    k_pool[step.write_at] = k.to(k_pool.dtype)
    v_pool[step.write_at] = v.to(v_pool.dtype)
    carry = ops_attn.init_carry(b, h, t, hd, device=q.device)
    for pages, mask in zip(step.chunk_pages, step.masks):
        k_c = k_pool[pages].reshape(b, step.chunk, kh, hd)
        v_c = v_pool[pages].reshape(b, step.chunk, kh, hd)
        carry = ops_attn.online_block_update(
            carry, q, ops_attn.repeat_kv(k_c, h), ops_attn.repeat_kv(v_c, h), mask, step.scale)
    acc, _, l = carry
    return ops_attn.finalize(acc, l, q.dtype)


class MLPBlock(nn.Module):
    """SwiGLU: w_down(silu(w_gate x) * w_up x)."""

    def __init__(self, cfg: DecoderConfig, device):
        super().__init__()
        self.w_gate = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_up = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_down = Dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, device)
        self.mlp = MLPBlock(cfg, device)

    def forward(self, x, positions, gates=None, segment_ids=None, kv=None):
        """``gates``: optional [2] float (attn, mlp) LOCO gates; a zero gate
        removes that sublayer's contribution and cuts its gradients. ``kv``:
        the cache path's ``(step, layer)``."""
        a = self.attn(self.attn_norm(x), positions, segment_ids, kv)
        x = x + (a if gates is None else a * gates[0].to(a.dtype))
        m = self.mlp(self.mlp_norm(x))
        return x + (m if gates is None else m * gates[1].to(m.dtype))


def _vocab_sharded(table) -> bool:
    """Whether ``table`` is the vocab-sharded DTensor that tensor
    parallelism makes of the embedding (:mod:`maggy_tpu_torch.parallel.sharding`)."""
    dtensor = sys.modules.get("torch.distributed.tensor")  # loaded wherever a DTensor exists
    return dtensor is not None and isinstance(table, dtensor.DTensor)


def _replicated(x, table):
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, table.device_mesh, [Replicate()], run_check=False)


def _gathered(y) -> torch.Tensor:
    from torch.distributed.tensor import Replicate

    return y.redistribute(placements=[Replicate()]).to_local()


def _lookup(tokens, table):
    """Embedding rows; over a vocab-sharded table each rank looks up the ids
    it holds and the partial rows are summed over ``tensor``."""
    if _vocab_sharded(table):
        return _gathered(F.embedding(_replicated(tokens, table), table))
    return F.embedding(tokens, table)


def _tied_logits(x, table):
    """``x @ table.T``; over a vocab-sharded table each rank computes its
    vocabulary's logits and they are gathered over ``tensor``."""
    if _vocab_sharded(table):
        return _gathered(F.linear(_replicated(x, table), table))
    return F.linear(x, table)


class Decoder(nn.Module):
    """LLaMA-style causal LM: ``forward(tokens [B,S]) -> logits [B,S,V]`` fp32.

    ``device`` defaults to CUDA and raises without it; ``device="meta"``
    builds the shapes only (for weights loaded later). Weights are drawn
    from ``generator`` with the JAX package's initialisers: N(0, 0.02) for
    projections, N(0, 1) for the embedding, ones for norm scales.

    ``layer_cls`` is the class of each layer (built as ``layer_cls(cfg,
    device)``, called as :class:`DecoderLayer` is); a model family with
    another layer (:class:`~maggy_tpu_torch.models.moe.MoEDecoder`) sets
    it."""

    layer_cls = DecoderLayer

    def __init__(self, cfg: DecoderConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype, device=device)
        )
        self.layers = nn.ModuleList(self.layer_cls(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else Dense(cfg.d_model, cfg.vocab_size, cfg, device)
        # [n_layers, 2] numpy LOCO gates or None; config, not state
        self._gates = _parse_ablated(cfg.ablated, cfg.n_layers)
        if device.type != "meta":
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embedding.normal_(0.0, 1.0, generator=generator)
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)

    def forward(self, tokens, positions=None, segment_ids=None, cache: Optional[KVCache] = None,
                kv_len: Optional[int] = None):
        """``positions`` default to per-row arange; packed batches pass both
        ``positions`` (restarting per segment) and ``segment_ids`` [B, S].

        With ``cache`` this is the decode path (no gradients): the tokens'
        K/V are appended to the cache at each row's index, which then moves
        on by the token count, and every query attends over its row's
        cache. ``kv_len`` is a host-known bound on the longest row's cache
        length after this write (``index + t``); without it the bound is
        read from the device. Later single-token calls of a packed cache may
        omit ``segment_ids``: the token extends its row's last segment."""
        if cache is not None:
            if positions is None:
                raise ValueError("the cache path needs explicit positions")
            with torch.no_grad():
                step = _CacheStep(self.cfg, cache, positions, segment_ids, kv_len)
                logits = self._forward(tokens, positions, None, step)
                cache.index.add_(tokens.shape[1])
            return logits
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        return self._forward(tokens, positions, segment_ids, None)

    def _forward(self, tokens, positions, segment_ids, step):
        cfg = self.cfg
        # gather-then-cast: the same values as casting the table first
        # (flax's jnp.asarray(embed, dtype)[tokens]) without a bf16 table copy
        x = _lookup(tokens, self.embedding).to(cfg.dtype)
        # no gradients (hence no remat) on the cache path
        recompute = cfg.remat and cfg.remat_policy != "everything" and step is None
        remat_kw = {}
        if recompute and cfg.remat_policy != "nothing":
            remat_kw["context_fn"] = functools.partial(_selective_context, cfg.remat_policy)
        all_gates = None if self._gates is None else torch.from_numpy(self._gates).to(x.device)
        for i, layer in enumerate(self.layers):
            gates = None if all_gates is None else all_gates[i]
            if recompute:
                x = checkpoint(layer, x, positions, gates, segment_ids, use_reentrant=False, **remat_kw)
            elif step is not None:
                x = layer(x, positions, gates, None, (step, i))
            else:
                x = layer(x, positions, gates, segment_ids)
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            logits = _tied_logits(x, self.embedding.to(cfg.dtype))
        else:
            logits = self.lm_head(x)
        if cfg.logits_softcap:
            logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
        return logits.float()
