"""Flagship model family: LLaMA-style decoder-only transformer (training path).

Counterpart of :mod:`maggy_tpu.models.transformer` for the non-decode path:
RMSNorm + RoPE + SwiGLU + grouped-query attention, bf16 compute over fp32
parameters, LOCO ablation gates, tied embeddings, logit soft-capping and
per-layer rematerialisation through :func:`torch.utils.checkpoint`.

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
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from maggy_tpu_torch.util import resolve_device

# remat policies by name. "nothing" recomputes the whole layer in the
# backward (minimum memory); "everything" saves it all (no recompute). The
# JAX package's "dots" and "dots_attn" save chosen matmul outputs and are
# not ported yet.
REMAT_POLICIES = ("nothing", "everything")
_QUEUED_POLICIES = ("dots", "dots_attn")


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
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # layout of the JAX parameter tree this config converts from
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "dots_attn"
    logits_softcap: float = 0.0
    tie_embeddings: bool = False
    attention_fn: Optional[Callable] = None
    # the serving (KV-cache) path is not ported yet; True raises
    decode: bool = False
    paged: bool = False
    # components gated to zero for LOCO ablation (see _parse_ablated)
    ablated: Any = frozenset()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.decode or self.paged:
            raise NotImplementedError("serving slice not ported yet")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.remat_policy not in REMAT_POLICIES + _QUEUED_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {sorted(REMAT_POLICIES + _QUEUED_POLICIES)}"
            )
        if self.remat and self.remat_policy in _QUEUED_POLICIES:
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not ported yet; "
                f"use one of {REMAT_POLICIES}"
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
                ),
                **overrides,
            }
        )


class Dense(nn.Module):
    """Bias-free projection computed in ``cfg.dtype``: input and fp32 weight
    are both cast, as flax's ``DenseGeneral(dtype=...)`` does."""

    def __init__(self, d_in: int, d_out: int, cfg: DecoderConfig, device):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(
            torch.empty((d_out, d_in), dtype=cfg.param_dtype, device=device)
        )

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

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(b, s, cfg.n_heads, hd)
        k = self.wk(x).view(b, s, cfg.n_kv_heads, hd)
        v = self.wv(x).view(b, s, cfg.n_kv_heads, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        attn = cfg.attention_fn or auto_attention
        out = attn(q, k, v, causal=True, segment_ids=segment_ids)
        return self.wo(out.reshape(b, s, cfg.n_heads * hd))


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

    def forward(self, x, positions, gates=None, segment_ids=None):
        """``gates``: optional [2] float (attn, mlp) LOCO gates; a zero gate
        removes that sublayer's contribution and cuts its gradients."""
        a = self.attn(self.attn_norm(x), positions, segment_ids)
        x = x + (a if gates is None else a * gates[0].to(a.dtype))
        m = self.mlp(self.mlp_norm(x))
        return x + (m if gates is None else m * gates[1].to(m.dtype))


class Decoder(nn.Module):
    """LLaMA-style causal LM: ``forward(tokens [B,S]) -> logits [B,S,V]`` fp32.

    ``device`` defaults to CUDA and raises without it; ``device="meta"``
    builds the shapes only (for weights loaded later). Weights are drawn
    from ``generator`` with the JAX package's initialisers: N(0, 0.02) for
    projections, N(0, 1) for the embedding, ones for norm scales."""

    def __init__(self, cfg: DecoderConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype, device=device)
        )
        self.layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
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

    def forward(self, tokens, positions=None, segment_ids=None):
        """``positions`` default to per-row arange; packed batches pass both
        ``positions`` (restarting per segment) and ``segment_ids`` [B, S]."""
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        # gather-then-cast: the same values as casting the table first
        # (flax's jnp.asarray(embed, dtype)[tokens]) without a bf16 table copy
        x = F.embedding(tokens, self.embedding).to(cfg.dtype)
        recompute = cfg.remat and cfg.remat_policy == "nothing"
        all_gates = None if self._gates is None else torch.from_numpy(self._gates).to(x.device)
        for i, layer in enumerate(self.layers):
            gates = None if all_gates is None else all_gates[i]
            if recompute:
                x = checkpoint(layer, x, positions, gates, segment_ids, use_reentrant=False)
            else:
                x = layer(x, positions, gates, segment_ids)
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            logits = F.linear(x, self.embedding.to(cfg.dtype))
        else:
            logits = self.lm_head(x)
        if cfg.logits_softcap:
            logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
        return logits.float()
