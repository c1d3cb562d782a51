"""Weights of the JAX package's ``Decoder``, ``Bert`` and ``MLP`` as PyTorch
``state_dict``s, and its decode cache as the port's ``KVCache``.

The JAX tree is taken as numpy arrays (``jax.device_get`` of the params, or
of ``{"params": ...}``), with its flax partitioning boxes either unboxed or
still in place: a leaf with a ``.value`` is read through it. This module
imports no JAX.

Layouts. flax ``DenseGeneral`` kernels are ``[in..., out...]``: ``wq``
``[d, H, hd]``, ``wk``/``wv`` ``[d, Kh, hd]``, ``wo`` ``[H, hd, d]``,
``w_gate``/``w_up`` ``[d, d_ff]``, ``w_down`` ``[d_ff, d]``, ``lm_head``
``[d, V]``; the port's weights are PyTorch's ``[out, in]``. With
``scan_layers=True`` every layer leaf is stacked on a leading layer axis
under ``layers/layer/...``; otherwise layer ``i`` sits under
``layers_{i}/layer/...``.

The JAX pipeline's stage-stacked tree (every leaf with a leading
``[n_stages]`` axis, the layers ``[n_stages, L / n_stages, ...]``) maps onto
the port's per-stage state dicts (:func:`decoder_stage_params_from_flax`),
and optax's AdamW moments ``mu``/``nu``, which mirror the parameter tree,
onto ``torch.optim.AdamW``'s per-parameter state
(:func:`adamw_state_from_optax`). The ``MoEDecoder``'s tree maps the same
way (:func:`moe_params_from_flax`; its pipelined state through
:func:`decoder_stage_params_from_flax`).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from maggy_tpu_torch.parallel.expert import is_moe


def _arr(x) -> np.ndarray:
    return np.asarray(getattr(x, "value", x))


def _flax_layer(tree, cfg, i: int):
    """Layer ``i``'s subtree of a Decoder-family tree, as numpy arrays."""
    if cfg.scan_layers:
        return _map(tree["layers"]["layer"], lambda x: _arr(x)[i])
    return _map(tree[f"layers_{i}"]["layer"], _arr)


def _attention_params(out: Dict[str, Any], pre: str, p, cfg) -> None:
    """A layer's norms and attention projections into ``out``."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = p["attn"]
    out[pre + "attn_norm.scale"] = p["attn_norm"]["scale"]
    out[pre + "mlp_norm.scale"] = p["mlp_norm"]["scale"]
    for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads), ("wv", cfg.n_kv_heads)):
        out[pre + f"attn.{name}.weight"] = attn[name]["kernel"].reshape(d, heads * hd).T
    out[pre + "attn.wo.weight"] = attn["wo"]["kernel"].reshape(cfg.n_heads * hd, d).T


def _as_state_dict(out: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(cfg.param_dtype) for k, v in out.items()}


def decoder_params_from_flax(params_np: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``maggy_tpu_torch.models.Decoder(cfg)`` from the
    JAX ``Decoder``'s params; ``cfg.scan_layers`` names the tree's layout.
    An ``MoEConfig`` reads the JAX ``MoEDecoder``'s (:func:`moe_params_from_flax`)."""
    if is_moe(cfg):
        return moe_params_from_flax(params_np, cfg)
    tree = params_np.get("params", params_np)
    out = {"embedding": _arr(tree["embedding"])}
    for i in range(cfg.n_layers):
        p = _flax_layer(tree, cfg, i)
        pre = f"layers.{i}."
        _attention_params(out, pre, p, cfg)
        for name in ("w_gate", "w_up", "w_down"):
            out[pre + f"mlp.{name}.weight"] = p["mlp"][name]["kernel"].T
    out["final_norm.scale"] = _arr(tree["final_norm"]["scale"])
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = _arr(tree["lm_head"]["kernel"]).T
    return _as_state_dict(out, cfg)


def moe_params_from_flax(params_np: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``maggy_tpu_torch.models.MoEDecoder(cfg)`` from
    the JAX ``MoEDecoder``'s params (scanned: ``layers/layer/moe/w_gate``
    ``[n_layers, e, d, d_ff]`` and so on). The expert weights keep JAX's
    ``[experts, ...]`` layout; the router's ``[d, e]`` kernel becomes a
    ``[e, d]`` weight."""
    tree = params_np.get("params", params_np)
    out = {"embedding": _arr(tree["embedding"])}
    for i in range(cfg.n_layers):
        p = _flax_layer(tree, cfg, i)
        pre = f"layers.{i}."
        _attention_params(out, pre, p, cfg)
        moe = p["moe"]
        out[pre + "moe.router.weight"] = moe["router"]["kernel"].T
        for name in ("w_gate", "w_up", "w_down"):
            out[pre + f"moe.{name}"] = moe[name]
    out["final_norm.scale"] = _arr(tree["final_norm"]["scale"])
    out["lm_head.weight"] = _arr(tree["lm_head"]["kernel"]).T
    return _as_state_dict(out, cfg)


def unstack_flax_stages(stage_tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX's stage-stacked Decoder tree as the scanned Decoder's: the
    embedding from stage 0, the final norm and head from the last stage,
    the layers' ``[n_stages, L / n_stages, ...]`` merged into ``[L, ...]``
    (``pipeline_adapter.unstack`` of the JAX package, on numpy arrays)."""
    tree = stage_tree.get("params", stage_tree)
    return {
        "embedding": _arr(tree["embedding"])[0],
        "layers": _map(tree["layers"], lambda x: _arr(x).reshape((-1,) + _arr(x).shape[2:])),
        "final_norm": _map(tree["final_norm"], lambda x: _arr(x)[-1]),
        **({"lm_head": _map(tree["lm_head"], lambda x: _arr(x)[-1])} if "lm_head" in tree else {}),
    }


def _stage_split(state_dict: Dict[str, Any], cfg, n_stages: int) -> List[Dict[str, Any]]:
    from maggy_tpu_torch.models.moe import MoEDecoder
    from maggy_tpu_torch.models.transformer import Decoder
    from maggy_tpu_torch.train.pipeline_adapter import decoder_pipeline_parts

    model = (MoEDecoder if is_moe(cfg) else Decoder)(cfg, device="meta")
    return decoder_pipeline_parts(model, n_stages).restack(state_dict)


def decoder_stage_params_from_flax(stage_tree: Dict[str, Any], cfg, n_stages: int) -> List[Dict[str, torch.Tensor]]:
    """One ``state_dict`` a stage (``DecoderStage``'s names, the
    Decoder's) from the JAX pipeline Trainer's stage-stacked params;
    ``cfg.scan_layers`` must be True, as the JAX pipeline requires. An
    ``MoEConfig`` reads JAX's pipelined ``MoEDecoder``: every leaf with a
    leading ``[n_stages]`` axis, the experts whole in each stage's layers."""
    return _stage_split(decoder_params_from_flax(unstack_flax_stages(stage_tree), cfg), cfg, n_stages)


def adamw_state_from_optax(opt_state, cfg, n_stages: Optional[int] = None):
    """``torch.optim.AdamW``'s state from optax's ``adamw`` state (the
    ``ScaleByAdamState`` in the chain: ``count``, and ``mu``/``nu``
    mirroring the parameters): ``{name: {"step", "exp_avg", "exp_avg_sq"}}``
    keyed by the port's parameter names, the moments laid out as the
    parameters are (an ``MoEConfig``'s as the ``MoEDecoder``'s). With
    ``n_stages`` the trees are JAX's stage-stacked pipeline trees and the
    result is one dict a stage."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    count = float(np.asarray(adam.count))

    def as_state_dict(tree):
        if n_stages is not None:
            tree = unstack_flax_stages(tree)
        return decoder_params_from_flax(tree, cfg)

    mu, nu = as_state_dict(adam.mu), as_state_dict(adam.nu)
    out = {name: {"step": torch.tensor(count, dtype=torch.float32), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
           for name in mu}
    return out if n_stages is None else _stage_split(out, cfg, n_stages)


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _cache_leaf(tree, cfg, name: str):
    """Cache leaf ``name`` of every layer, stacked on a leading layer axis:
    ``layers/layer/attn/<name>`` already is when scanned, else one leaf per
    ``layers_<i>``. None when the cache has no such leaf."""
    if cfg.scan_layers:
        attn = tree["layers"]["layer"]["attn"]
        return _arr(attn[name]) if name in attn else None
    attns = [tree[f"layers_{i}"]["layer"]["attn"] for i in range(cfg.n_layers)]
    if name not in attns[0]:
        return None
    return np.stack([_arr(a[name]) for a in attns])


def kv_cache_from_flax(cache_np: Dict[str, Any], cfg, device="cpu"):
    """The port's ``KVCache`` holding the same state as a JAX decode cache
    (numpy: ``jax.device_get`` of the ``"cache"`` collection, or of
    ``{"cache": ...}``), scanned ``[L, ...]`` or per-layer as
    ``cfg.scan_layers`` says. K/V keep their layout (``[L, B, S, Kh, D]``
    dense, ``[L, N, P, Kh, D]`` paged); the write index, the page table and
    the segment-id track, identical in every layer, are taken from layer 0."""
    from maggy_tpu_torch.models.transformer import KVCache

    tree = cache_np.get("cache", cache_np)

    def tensor(name, dtype):
        leaf = _cache_leaf(tree, cfg, name)
        return None if leaf is None else torch.from_numpy(np.array(leaf)).to(device=device, dtype=dtype)

    def first_layer(name):
        t = tensor(name, torch.int32)
        return None if t is None else t[0].contiguous()

    return KVCache(
        k=tensor("k", cfg.dtype), v=tensor("v", cfg.dtype), index=first_layer("index"),
        pages=first_layer("pages"), seg=first_layer("seg"),
    )


def mlp_params_from_flax(params_np: Dict[str, Any], features_count: int) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``maggy_tpu_torch.models.MLP`` from the JAX ``MLP``'s
    params (``dense_0 .. dense_{features_count-1}`` and ``head``, each a flax
    ``Dense`` with an ``[in, out]`` kernel and a bias)."""
    tree = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    for name in [f"dense_{i}" for i in range(features_count)] + ["head"]:
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(_arr(tree[name]["kernel"]).T))
        out[f"{name}.bias"] = torch.from_numpy(np.array(_arr(tree[name]["bias"])))
    return out


def bert_params_from_flax(params_np: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``maggy_tpu_torch.models.Bert(cfg)`` from the JAX
    ``Bert``'s params: the full tree, or an ablated variant's as it stands
    (``cfg.ablated`` names what it lacks). The q/k/v kernels are ``[d, H,
    hd]``, ``wo`` is ``[H, hd, d]``, ``w_in``/``w_out``/``pooler`` are plain
    ``[in, out]``; the classifier is a flax ``Dense`` with a bias."""
    tree = params_np.get("params", params_np)
    d, inner = cfg.d_model, cfg.n_heads * cfg.head_dim()

    def norm(prefix, p):
        return {prefix + "scale": _arr(p["scale"]), prefix + "bias": _arr(p["bias"])}

    out = {"embedding": _arr(tree["embedding"])}
    if "position_embeddings" not in cfg.ablated:
        out["position_embedding"] = _arr(tree["position_embedding"])
    for i in range(cfg.n_layers):
        name = f"layer_{i}"
        if name in cfg.ablated:
            continue
        p = _map(tree[name], _arr)
        pre = f"layers.{name}."
        out.update(norm(pre + "attn_norm.", p["attn_norm"]))
        out.update(norm(pre + "mlp_norm.", p["mlp_norm"]))
        for w in ("wq", "wk", "wv"):
            out[pre + f"{w}.weight"] = p[w]["kernel"].reshape(d, inner).T
        out[pre + "wo.weight"] = p["wo"]["kernel"].reshape(inner, d).T
        out[pre + "w_in.weight"] = p["w_in"]["kernel"].T
        out[pre + "w_out.weight"] = p["w_out"]["kernel"].T
    out.update(norm("final_norm.", _map(tree["final_norm"], _arr)))
    if "pooler" not in cfg.ablated:
        out["pooler.weight"] = _arr(tree["pooler"]["kernel"]).T
    out["classifier.weight"] = _arr(tree["classifier"]["kernel"]).T
    out["classifier.bias"] = _arr(tree["classifier"]["bias"])
    return {
        k: torch.from_numpy(np.array(v)).to(cfg.param_dtype)
        for k, v in out.items()
    }
