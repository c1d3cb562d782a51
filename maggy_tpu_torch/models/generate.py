"""Autoregressive generation for the decoder.

Counterpart of :mod:`maggy_tpu.models.generate`. Two paths over a token
buffer padded to ``max_len``, filled one position per step:

* :func:`generate` recomputes the whole prefix each step with the training
  forward (O(L·S²) compute, no cache; on the card it runs the flash kernels);
* :func:`generate_cached` decodes one token of compute per step against a
  :class:`~maggy_tpu_torch.models.transformer.KVCache`; :func:`prefill` and
  :func:`generate_cached_packed` fill a cache in one pass first.

Greedy (``temperature=0``) or temperature sampling with optional top-k, drawn
from a ``torch.Generator``. Every loop stays on the device: nothing is read
back to the host until the caller reads the result. The JAX package's
``cache_shardings`` and ``mesh`` arguments belong to the multi-device slice
(ROADMAP queue 1 item 7g): passing a mesh raises.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from maggy_tpu_torch.models.transformer import KVCache


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded KV caches belong to the multi-device slice (ROADMAP queue 1 item 7g)"
        )


def _default_rng(temperature: float, where: str, device) -> torch.Generator:
    """Sampling (``temperature > 0``) with the default generator, seeded 0,
    returns IDENTICAL tokens on every call: warn when that bites. Greedy
    decode stays silent, since it draws nothing."""
    if temperature > 0.0:
        warnings.warn(
            f"{where}: temperature sampling with the fixed default generator "
            "(seed 0) — repeated calls return identical samples; pass "
            "rng=torch.Generator(device).manual_seed(<fresh seed>) per call",
            UserWarning,
            stacklevel=3,
        )
    return torch.Generator(device=device).manual_seed(0)


def _sample(last: torch.Tensor, rng: torch.Generator, temperature: float, top_k: int) -> torch.Tensor:
    """[B, V] logits -> [B] tokens: argmax (first index on ties) when
    greedy; else the Gumbel-max draw over ``last / temperature`` with all
    but the ``top_k`` largest set to -1e30."""
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)
    scaled = last.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30), scaled)
    u = torch.rand(scaled.shape, generator=rng, device=scaled.device).clamp_(min=1e-20)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate(
    model,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    *,
    rng: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_id: int = -1,
) -> torch.Tensor:
    """Fill the buffer after each row's prompt with sampled continuations.

    :param prompt: int [B, max_len] buffer — prompt tokens left-aligned,
        tail arbitrary (overwritten).
    :param prompt_len: int [B] true prompt lengths (>= 1).
    :param rng: generator for temperature sampling; defaults to one seeded
        0, so repeated calls return identical samples.
    :returns: [B, max_len]; after a row hits ``eos_id`` it repeats it.
    """
    tokens = prompt.clone()
    max_len = tokens.shape[1]
    if rng is None:
        rng = _default_rng(temperature, "generate", tokens.device)
    prompt_len = prompt_len.to(tokens.device)
    done = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    for p in range(max_len - 1):
        logits = model(tokens)  # [B, max_len, V]
        nxt = _sample(logits[:, p], rng, temperature, top_k).to(tokens.dtype)
        # position p+1 gets a generated token only once the prompt is consumed
        generating = (p + 1) >= prompt_len
        if eos_id >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            # discarded mid-prompt predictions must not latch the done flag
            done = done | (generating & (nxt == eos_id))
        tokens[:, p + 1] = torch.where(generating, nxt, tokens[:, p + 1])
    return tokens


def init_cache(model, prompt: torch.Tensor, mesh=None, packed: bool = False) -> KVCache:
    """A zeroed cache for ``model`` (a ``Decoder`` or its config) with
    ``prompt``'s batch size, on ``prompt``'s device: dense rows of
    ``max_seq_len``, or with ``cfg.paged`` a pool of ``num_pages`` pages
    whose page table maps every entry to the scratch page (the caller
    assigns pages). ``packed=True`` adds the segment-id track packed
    prefill caches alongside K/V."""
    _no_mesh(mesh)
    cfg = getattr(model, "cfg", model)
    b, dev = prompt.shape[0], prompt.device
    L, kh, hd, s = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    index = torch.zeros((b,), dtype=torch.int32, device=dev)
    if cfg.paged:
        if packed:
            raise NotImplementedError("paged decode does not support packed segment_ids")
        shape = (L, cfg.num_pages, cfg.page_size, kh, hd)
        pages = torch.zeros((b, s // cfg.page_size), dtype=torch.int32, device=dev)
        return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       torch.zeros(shape, dtype=cfg.dtype, device=dev), index, pages)
    shape = (L, b, s, kh, hd)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev) if packed else None
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev), index, seg=seg)


@torch.no_grad()
def prefill(model, tokens, positions, segment_ids=None, cache: Optional[KVCache] = None, mesh=None,
            kv_len: Optional[int] = None):
    """ONE-pass cache fill: run the whole prompt — packed or plain — through
    the cache path at once, writing every K/V (+ segment id) slot in a
    single forward. Returns ``(logits [B, T, V], cache)``; feed the cache to
    further single-token calls or :func:`generate_cached_packed`.
    ``kv_len`` bounds the rows' cache lengths afterwards (T for a cache made
    here; read from the device when a cache is passed without it)."""
    _no_mesh(mesh)
    if cache is None:
        cache = init_cache(model, tokens, packed=segment_ids is not None)
        kv_len = tokens.shape[1]
    logits = model(tokens, positions, segment_ids, cache=cache, kv_len=kv_len)
    return logits, cache


@torch.no_grad()
def generate_cached_packed(
    model,
    prompt: torch.Tensor,
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    *,
    max_new: int,
    rng: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_id: int = -1,
):
    """Packed serving: one :func:`prefill` pass over a FULLY-packed prompt
    buffer ``[B, T]`` (``positions`` restart per segment), then ``max_new``
    cached single-token steps continuing each row's LAST segment; earlier
    segments stay context-isolated by the cache's segment mask.

    :returns: ``(prefill_logits [B, T, V], new_tokens [B, max_new])``.
    """
    b, t = prompt.shape
    max_seq = model.cfg.max_seq_len
    if t + max_new > max_seq:
        raise ValueError(
            f"prompt ({t}) + max_new ({max_new}) exceeds the cache's max_seq_len ({max_seq})"
        )
    if rng is None:
        rng = _default_rng(temperature, "generate_cached_packed", prompt.device)
    logits, cache = prefill(model, prompt, positions, segment_ids)
    last_pos = positions[:, -1:]
    tokens = torch.zeros((b, max_new), dtype=prompt.dtype, device=prompt.device)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    cur = logits[:, -1]
    for i in range(max_new):
        nxt = _sample(cur, rng, temperature, top_k).to(prompt.dtype)
        if eos_id >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tokens[:, i] = nxt
        cur = model(nxt[:, None], last_pos + 1 + i, cache=cache, kv_len=t + i + 1)[:, 0]
    return logits, tokens


@torch.no_grad()
def generate_cached(
    model,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    *,
    rng: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_id: int = -1,
) -> torch.Tensor:
    """KV-cache incremental generation: one token of compute per step
    (O(L·S·d) instead of :func:`generate`'s O(L·S²·d) prefix recompute),
    with :func:`generate`'s sampling semantics. ``model`` is the trained
    ``Decoder``; its config's ``max_seq_len`` must hold ``max_len``."""
    tokens = prompt.clone()
    b, max_len = tokens.shape
    if max_len > model.cfg.max_seq_len:
        raise ValueError(f"max_len ({max_len}) exceeds max_seq_len ({model.cfg.max_seq_len})")
    if rng is None:
        rng = _default_rng(temperature, "generate_cached", tokens.device)
    prompt_len = prompt_len.to(tokens.device)
    cache = init_cache(model, tokens)
    done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
    for p in range(max_len - 1):
        pos = torch.full((b, 1), p, dtype=torch.int32, device=tokens.device)
        logits = model(tokens[:, p:p + 1], pos, cache=cache, kv_len=p + 1)
        nxt = _sample(logits[:, 0], rng, temperature, top_k).to(tokens.dtype)
        generating = (p + 1) >= prompt_len
        if eos_id >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (generating & (nxt == eos_id))
        tokens[:, p + 1] = torch.where(generating, nxt, tokens[:, p + 1])
    return tokens
