"""Weights of the JAX package's ``Decoder`` and ``MLP`` as PyTorch
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
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch


def _arr(x) -> np.ndarray:
    return np.asarray(getattr(x, "value", x))


def decoder_params_from_flax(params_np: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``maggy_tpu_torch.models.Decoder(cfg)`` from the
    JAX ``Decoder``'s params; ``cfg.scan_layers`` names the tree's layout."""
    tree = params_np.get("params", params_np)
    d, hd = cfg.d_model, cfg.head_dim

    def layer(i: int):
        if cfg.scan_layers:
            stacked = tree["layers"]["layer"]
            return _map(stacked, lambda x: _arr(x)[i])
        return _map(tree[f"layers_{i}"]["layer"], _arr)

    out = {"embedding": _arr(tree["embedding"])}
    for i in range(cfg.n_layers):
        p = layer(i)
        attn, mlp = p["attn"], p["mlp"]
        pre = f"layers.{i}."
        out[pre + "attn_norm.scale"] = p["attn_norm"]["scale"]
        out[pre + "mlp_norm.scale"] = p["mlp_norm"]["scale"]
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads), ("wv", cfg.n_kv_heads)):
            out[pre + f"attn.{name}.weight"] = attn[name]["kernel"].reshape(d, heads * hd).T
        out[pre + "attn.wo.weight"] = attn["wo"]["kernel"].reshape(cfg.n_heads * hd, d).T
        for name in ("w_gate", "w_up", "w_down"):
            out[pre + f"mlp.{name}.weight"] = mlp[name]["kernel"].T
    out["final_norm.scale"] = _arr(tree["final_norm"]["scale"])
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = _arr(tree["lm_head"]["kernel"]).T
    return {
        k: torch.from_numpy(np.array(v)).to(cfg.param_dtype)
        for k, v in out.items()
    }


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
