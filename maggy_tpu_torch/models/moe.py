"""Mixtral-style sparse Mixture-of-Experts decoder.

Counterpart of :mod:`maggy_tpu.models.moe`: GShard dense dispatch. Tokens
are routed in fixed groups of ``group_size``; each token's top-k experts
(renormalised gates) take a slot in the expert's queue of static
``capacity``, top-1 assignments before top-2 ones, and a token past
capacity is dropped for that expert. The dispatch and combine one-hots
``[groups, group, experts, capacity]`` move the tokens to the experts and
back; the expert FFNs are one batched SwiGLU over weights laid out
``[experts, ...]`` as JAX's (``w_gate``/``w_up`` ``[e, d, d_ff]``,
``w_down`` ``[e, d_ff, d]``), and the router adds the Switch-style
load-balancing loss, read after a forward by
:func:`maggy_tpu_torch.train.trainer.collect_aux_losses`.

The layers attend through the Decoder's :class:`Attention` (the flash
kernels on CUDA) and :class:`MoEDecoder` is a :class:`Decoder` with MoE
layers, so the KV-cache decode path, the LOCO gates and remat are the
Decoder's. Top-k ties go to the lower expert index, as ``jax.lax.top_k``
breaks them (a stable descending sort): the router's logits are taken in
``cfg.dtype``, so equal probabilities do occur. This module adds no kernel
of its own: the JAX package computes the expert einsums outside any Pallas
kernel, and they stay PyTorch's batched matmuls here.

Under expert and tensor parallelism (:mod:`maggy_tpu_torch.parallel.expert`)
a block holds only its rank's experts (and under ``tensor`` their hidden
columns), and its :attr:`MoEBlock.placement` says how it exchanges their
tokens and sums their partial products; unlike JAX's, the decoder never ties its
embeddings nor soft-caps its logits, so a config asking for either raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.transformer import Attention, Decoder, DecoderConfig, Dense, RMSNorm
from maggy_tpu_torch.parallel import expert as ep


@dataclasses.dataclass(frozen=True)
class MoEConfig(DecoderConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # tokens are routed in fixed-size groups so the dispatch one-hot is
    # O(tokens * group_size), not O(tokens^2): the GShard group axis
    group_size: int = 512

    @classmethod
    def mixtral_8x7b(cls, **overrides) -> "MoEConfig":
        """Mixtral-8x7B geometry (BASELINE config 5)."""
        return cls(
            **{
                **dict(
                    vocab_size=32_000,
                    d_model=4096,
                    n_layers=32,
                    n_heads=32,
                    n_kv_heads=8,
                    d_ff=14_336,
                    n_experts=8,
                    top_k=2,
                    max_seq_len=8192,
                    remat=True,
                ),
                **overrides,
            }
        )

    @classmethod
    def tiny_moe(cls, **overrides) -> "MoEConfig":
        return cls(
            **{
                **dict(
                    vocab_size=256,
                    d_model=64,
                    n_layers=2,
                    n_heads=4,
                    n_kv_heads=2,
                    d_ff=96,
                    n_experts=4,
                    top_k=2,
                ),
                **overrides,
            }
        )


def top_k_lowest_first(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of the last dim,
    largest first and equal values in index order, as ``jax.lax.top_k``
    returns them (``torch.topk`` promises no order among equals)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def capacity_of(cfg: MoEConfig, g: int) -> int:
    """Slots per expert and group: JAX's ``max(top_k, ceil(g / e * top_k
    * capacity_factor))``."""
    return max(cfg.top_k, int(math.ceil(g / cfg.n_experts * cfg.top_k * cfg.capacity_factor)))


class MoEBlock(nn.Module):
    """Top-k routed SwiGLU experts with static capacity. After a forward,
    ``aux_loss`` holds its router term (a 0-d fp32 tensor)."""

    def __init__(self, cfg: MoEConfig, device):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = Dense(d, e, cfg, device)
        self.w_gate = nn.Parameter(torch.empty((e, d, f), dtype=cfg.param_dtype, device=device))
        self.w_up = nn.Parameter(torch.empty((e, d, f), dtype=cfg.param_dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((e, f, d), dtype=cfg.param_dtype, device=device))
        # expert parallelism (parallel.expert.expert_parallelize); None on one device
        self.placement: Optional[ep.ExpertPlacement] = None
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, aux_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        e, k = cfg.n_experts, cfg.top_k
        place = self.placement
        g = min(cfg.group_size, t) if place is None else place.group_size(cfg, t)
        n_groups = -(-t // g)
        pad = n_groups * g - t
        capacity = capacity_of(cfg, g)

        tokens = x.reshape(t, d)
        if pad:
            tokens = F.pad(tokens, (0, 0, 0, pad))
        grouped = tokens.reshape(n_groups, g, d)

        router_probs = torch.softmax(self.router(grouped).float(), dim=-1)
        gate_vals, expert_idx = top_k_lowest_first(router_probs, k)  # [n,g,k]
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

        # GShard dispatch per group: each (token, k)'s position in its
        # expert's queue; top-1 assignments take slots before top-2 ones
        onehot = F.one_hot(expert_idx, e)  # [n,g,k,e] int64
        flat = onehot.transpose(1, 2).reshape(n_groups, k * g, e)
        pos_flat = torch.cumsum(flat, dim=1) - flat
        pos = pos_flat.reshape(n_groups, k, g, e).transpose(1, 2)
        pos_in_expert = (pos * onehot).sum(-1)  # [n,g,k]
        within = pos_in_expert < capacity

        dt = x.dtype
        slot = F.one_hot(torch.clamp(pos_in_expert, max=capacity - 1), capacity).to(dt)
        disp = (onehot.to(dt)[..., None] * slot[..., None, :]
                * within[..., None, None].to(dt))  # [n,g,k,e,c]
        combine = (disp * gate_vals[..., None, None].to(dt)).sum(2)  # [n,g,e,c]
        dispatch = disp.sum(2)

        expert_in = torch.einsum("ngec,ngd->necd", dispatch, grouped)
        # fold the groups into the expert batch: experts see [e, n*c, d]
        expert_in = expert_in.transpose(0, 1).reshape(e, n_groups * capacity, d)
        # this rank's experts, then (under ``tensor``) its hidden columns:
        # the FFNs' partial products are summed over ``tensor`` before the
        # experts are gathered, so ``expert_out`` is whole for the combine
        expert_in = ep.tensor_in(ep.take_experts(expert_in, place), place)
        w_gate, w_up, w_down = (ep.local_weight(w).to(cfg.dtype) for w in (self.w_gate, self.w_up, self.w_down))
        hidden = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
        expert_out = ep.gather_experts(ep.tensor_out(torch.bmm(hidden, w_down), place), place)
        expert_out = expert_out.reshape(e, n_groups, capacity, d).transpose(0, 1)

        y = torch.einsum("ngec,necd->ngd", combine, expert_out).reshape(-1, d)
        if pad:
            y = y[:t]
        y = y.reshape(b, s, d)

        # load-balancing auxiliary loss (Switch/Mixtral style), over the
        # global batch; a LOCO gate scales it too, so an ablated block adds
        # no balancing gradients
        me = ep.batch_mean(router_probs.reshape(-1, e).mean(0), place)  # mean router prob
        ce = ep.batch_mean(F.one_hot(expert_idx[..., 0], e).float().reshape(-1, e).mean(0), place)
        aux = (me * ce).sum() * e * cfg.router_aux_weight
        if aux_gate is not None:
            aux = aux * aux_gate.to(aux.dtype)
        self.aux_loss = aux
        return y


class MoELayer(nn.Module):
    def __init__(self, cfg: MoEConfig, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, device)
        self.moe = MoEBlock(cfg, device)

    def forward(self, x, positions, gates=None, segment_ids=None, kv=None):
        """``gates``: optional [2] float (attn, moe) LOCO gates, as the
        DecoderLayer's; the moe gate also scales the router's aux loss.
        ``kv``: the cache path's ``(step, layer)``."""
        a = self.attn(self.attn_norm(x), positions, segment_ids, kv)
        x = x + (a if gates is None else a * gates[0].to(a.dtype))
        m = self.moe(self.mlp_norm(x), aux_gate=None if gates is None else gates[1])
        return x + (m if gates is None else m * gates[1].to(m.dtype))


class MoEDecoder(Decoder):
    """Sparse-MoE causal LM with the :class:`Decoder`'s interface:
    ``forward(tokens [B,S], positions, segment_ids, cache=, kv_len=) ->
    logits [B,S,V]`` fp32. Weights are drawn as JAX draws them: N(0, 0.02)
    for the router, the experts and the projections, N(0, 1) for the
    embedding, ones for the norm scales."""

    layer_cls = MoELayer

    def __init__(self, cfg: MoEConfig, *, device=None, generator=None):
        if not isinstance(cfg, MoEConfig):
            raise TypeError(f"MoEDecoder takes an MoEConfig, got {type(cfg).__name__}")
        if cfg.tie_embeddings or cfg.logits_softcap:
            raise ValueError(
                "the MoE decoder has its own lm_head and no logit soft-cap (as JAX's, which ignores "
                "tie_embeddings and logits_softcap); unset both"
            )
        super().__init__(cfg, device=device, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters(generator)
        for _, block in ep.moe_blocks(self):
            for w in ep.EXPERT_WEIGHTS:
                getattr(block, w).normal_(0.0, 0.02, generator=generator)
