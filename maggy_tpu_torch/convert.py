"""Weights of the JAX package's ``Decoder`` as a PyTorch ``state_dict``.

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
