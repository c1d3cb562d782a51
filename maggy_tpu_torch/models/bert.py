"""BERT-style bidirectional encoder (BASELINE config 4: BERT-base ablation).

Counterpart of :mod:`maggy_tpu.models.bert`: learned positions, bidirectional
blockwise attention, post-attention residual blocks under pre-LayerNorm, a
tanh pooler and a classifier. Components are named so that an ablation study
can drop them: ``"position_embeddings"``, ``"pooler"`` and any
``"layer_{i}"`` listed in ``cfg.ablated`` are left out of the module, not
gated, so an ablated variant has fewer parameters.

Numerics follow flax's: every dense layer casts its input and its fp32
weight to ``cfg.dtype``; LayerNorm takes its statistics in fp32 with flax's
fast variance ``E[x²] - E[x]²`` (clipped at 0) and rounds only its output;
GELU is the tanh approximation (``nn.gelu``'s default); the embedding table
is gathered then cast (the same values as flax's cast-then-gather); the
classifier computes in fp32 from the ``cfg.dtype`` CLS row. Attention is the
port's plain :func:`~maggy_tpu_torch.ops.attention.blockwise_attention`, as
the JAX model's is plain XLA outside any Pallas kernel; padding tokens get
segment -1, so they attend only to each other.

Layers live in an ``nn.ModuleDict`` keyed ``layer_{i}``: dropping
``layer_0`` leaves ``layer_1`` ... under their own names, as in the JAX tree
(:func:`maggy_tpu_torch.convert.bert_params_from_flax` maps one onto the
other). Dropout runs only in ``train()`` mode and draws from an explicit
generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, FrozenSet, Optional

import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.transformer import Dense
from maggy_tpu_torch.ops.attention import blockwise_attention
from maggy_tpu_torch.util import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    num_classes: int = 2
    dropout: float = 0.1
    norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    ablated: FrozenSet[str] = frozenset()  # component names dropped by LOCO

    def __post_init__(self):
        object.__setattr__(self, "ablated", frozenset(self.ablated))

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        return cls(
            **{
                **dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                       max_seq_len=64, dropout=0.0),
                **kw,
            }
        )

    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=cfg.dtype)``: fp32 statistics, scale and
    bias applied in fp32, the output rounded to ``cfg.dtype``."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.scale = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(cfg.d_model, dtype=cfg.param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.cfg.norm_eps) * self.scale.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.cfg.dtype)


def _dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale the kept."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        inner = cfg.n_heads * cfg.head_dim()
        self.attn_norm = LayerNorm(cfg, device)
        self.wq = Dense(cfg.d_model, inner, cfg, device)
        self.wk = Dense(cfg.d_model, inner, cfg, device)
        self.wv = Dense(cfg.d_model, inner, cfg, device)
        self.wo = Dense(inner, cfg.d_model, cfg, device)
        self.mlp_norm = LayerNorm(cfg, device)
        self.w_in = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_out = Dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x, seg, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim()
        h = self.attn_norm(x)
        q = self.wq(h).view(b, s, cfg.n_heads, hd)
        k = self.wk(h).view(b, s, cfg.n_heads, hd)
        v = self.wv(h).view(b, s, cfg.n_heads, hd)
        attn = blockwise_attention(q, k, v, causal=False, segment_ids=seg)
        x = x + self.wo(attn.reshape(b, s, cfg.n_heads * hd))
        h = self.w_out(F.gelu(self.w_in(self.mlp_norm(x)), approximate="tanh"))
        if generator is not None:
            h = _dropout(h, cfg.dropout, generator)
        return x + h


class Bert(nn.Module):
    """``forward(tokens [B,S], attention_mask [B,S]=None) -> (pooled_logits
    fp32 [B, num_classes], sequence_output [B,S,d])``. Ablatable components:
    ``"position_embeddings"``, ``"pooler"`` and any ``"layer_{i}"``.

    ``device`` defaults to CUDA and raises without it; ``device="meta"``
    builds the shapes only. Weights are drawn from ``generator`` with the
    JAX package's initialisers: N(0, 0.02) for the embeddings and
    projections, flax ``Dense``'s LeCun normal (truncated) and zero bias for
    the classifier, ones and zeros for the LayerNorms."""

    def __init__(self, cfg: BertConfig = BertConfig.tiny(), *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        ablated = cfg.ablated
        self.embedding = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype, device=device)
        )
        self.position_embedding = (
            None if "position_embeddings" in ablated
            else nn.Parameter(torch.empty((cfg.max_seq_len, cfg.d_model), dtype=cfg.param_dtype, device=device))
        )
        self.layers = nn.ModuleDict(
            (f"layer_{i}", BertLayer(cfg, device))
            for i in range(cfg.n_layers) if f"layer_{i}" not in ablated
        )
        self.final_norm = LayerNorm(cfg, device)
        self.pooler = None if "pooler" in ablated else Dense(cfg.d_model, cfg.d_model, cfg, device)
        self.classifier = nn.Linear(cfg.d_model, cfg.num_classes, dtype=cfg.param_dtype, device=device)
        # dropout's generator when forward() is given none (made at first
        # use on the tokens' device, seeded 0)
        self.dropout_generator: Optional[torch.Generator] = None
        if device.type != "meta":
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embedding.normal_(0.0, 0.02, generator=generator)
        if self.position_embedding is not None:
            self.position_embedding.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        # flax's lecun_normal: a normal truncated at two standard deviations,
        # rescaled so that its variance is 1 / fan_in
        std = math.sqrt(1.0 / self.cfg.d_model) / 0.87962566103423978
        nn.init.trunc_normal_(self.classifier.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.classifier.bias.zero_()

    def forward(self, tokens, attention_mask=None, *, generator: Optional[torch.Generator] = None):
        """``generator`` feeds dropout in ``train()`` mode (default: the
        module's ``dropout_generator``); in ``eval()`` mode, or with
        ``cfg.dropout == 0``, nothing is dropped."""
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = torch.ones_like(tokens)
        drop = None
        if self.training and cfg.dropout:
            if generator is None:
                if self.dropout_generator is None:
                    self.dropout_generator = torch.Generator(device=tokens.device).manual_seed(0)
                generator = self.dropout_generator
            drop = generator
        x = F.embedding(tokens, self.embedding).to(cfg.dtype)
        if self.position_embedding is not None:
            x = x + self.position_embedding[: tokens.shape[1]].to(cfg.dtype)[None]
        # segment ids: padding tokens get -1 so they never attend/are attended
        seg = torch.where(attention_mask > 0, 0, -1).to(torch.int32)
        for layer in self.layers.values():
            x = layer(x, seg, drop)
        x = self.final_norm(x)
        cls = x[:, 0]
        if self.pooler is not None:
            cls = torch.tanh(self.pooler(cls))
        logits = F.linear(cls.float(), self.classifier.weight.float(), self.classifier.bias.float())
        return logits, x
