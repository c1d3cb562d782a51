"""The port's KV-cache decode path against the JAX package's ``Decoder(decode=True)``.

Weights come from the JAX ``Decoder``'s init through
``decoder_params_from_flax``; the same tokens (numpy, from a seed) go through
both, and every call's logits are compared. The geometry is
``DecoderConfig.tiny`` in float32 (vocab 256, d 64, 2 layers, 4 heads, 2 KV
heads). Tolerance: atol/rtol 1e-5, as the training path's fp32 parity
(``test_torch_transformer.py``): the same math with sums in another order.

Cases: a prefill; single-token steps with the rows at different indices;
reads over several chunks (``decode_chunk=16``); the packed segment-id
track, prefill then continuation; a paged cache under shuffled page tables;
an overlong write that hits the row-write clamp; scanned and unscanned
layouts. Then a decode step from a JAX cache carried over by
``kv_cache_from_flax``, and, within the port, paged == dense bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import transformer as jt
from maggy_tpu.models.generate import init_cache as jax_init_cache
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import decoder_params_from_flax, kv_cache_from_flax
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.models.generate import init_cache

torch.set_num_threads(2)
ATOL = RTOL = 1e-5
B = 2
PAGE = 8


@functools.lru_cache(maxsize=None)
def _jax_apply(jcfg):
    """One jitted apply per config, shared by the tests (compiles per shape)."""
    return jax.jit(functools.partial(jt.Decoder(jcfg).apply, mutable=["cache"]))


@functools.lru_cache(maxsize=None)
def _params(scan_layers: bool):
    cfg = jt.DecoderConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers)
    return unbox(jt.Decoder(cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


class Pair:
    """One config on both sides: the JAX decode model with its cache, and
    the port's Decoder with its KVCache, driven call by call."""

    def __init__(self, scan_layers=True, paged=False, **kw):
        base = dict(dtype=jnp.float32, scan_layers=scan_layers, **kw)
        if paged:
            base.update(page_size=PAGE, num_pages=4 * B * kw.get("max_seq_len", 128) // PAGE + 1)
        self.jcfg = jt.DecoderConfig.tiny(**base, decode=True, paged=paged)
        self.tcfg = tt.DecoderConfig.tiny(**{**base, "dtype": torch.float32}, decode=True, paged=paged)
        params = _params(scan_layers)
        self.params = params
        self.model = tt.Decoder(self.tcfg, device="cpu")
        self.model.load_state_dict(decoder_params_from_flax(jax.device_get(params), self.tcfg))
        self.jmodel = jt.Decoder(self.jcfg)
        self.jcache = None
        self.cache = None
        self._apply = _jax_apply(self.jcfg)

    def start(self, packed=False):
        dummy = jnp.zeros((B, 1), jnp.int32)
        self.jcache = jax_init_cache(self.jmodel, dummy, packed=packed)
        self.cache = init_cache(self.model, torch.zeros((B, 1), dtype=torch.int32), packed=packed)

    def set(self, name, value):
        """Set cache variable ``name`` (``index`` or ``pages``) on both sides."""
        value = np.ascontiguousarray(value, np.int32)

        def leaf(path, x):
            if jax.tree_util.keystr(path).endswith(f"['{name}']"):
                return jnp.broadcast_to(jnp.asarray(value), x.shape)
            return x

        self.jcache = jax.tree_util.tree_map_with_path(leaf, self.jcache)
        getattr(self.cache, name).copy_(torch.from_numpy(value))

    def call(self, tokens, positions, segment_ids=None, kv_len=None):
        args = (jnp.asarray(tokens), jnp.asarray(positions))
        targs = (torch.from_numpy(tokens), torch.from_numpy(positions))
        if segment_ids is not None:
            args += (jnp.asarray(segment_ids),)
        jl, mut = self._apply({"params": self.params, "cache": self.jcache}, *args)
        self.jcache = mut["cache"]
        seg = None if segment_ids is None else torch.from_numpy(segment_ids)
        tl = self.model(*targs, seg, cache=self.cache, kv_len=kv_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
        return tl


def _tokens(rng, t):
    return rng.integers(0, 256, (B, t)).astype(np.int32)


def _arange(start, t):
    start = np.broadcast_to(np.asarray(start, np.int32), (B,))
    return (start[:, None] + np.arange(t, dtype=np.int32)[None, :]).astype(np.int32)


def _prefill_and_steps(pair, rng, t, steps, at=None, kv_len=True):
    """Prefill ``t`` tokens, optionally move the rows to the indices ``at``,
    then ``steps`` single-token steps at each row's own position."""
    pair.call(_tokens(rng, t), _arange(0, t), kv_len=t if kv_len else None)
    idx = np.full((B,), t) if at is None else np.asarray(at)
    if at is not None:
        pair.set("index", idx)
    for i in range(steps):
        pair.call(_tokens(rng, 1), _arange(idx + i, 1), kv_len=int(idx.max()) + i + 1 if kv_len else None)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "no_scan"])
def test_prefill_and_steps_at_different_indices(scan_layers):
    pair = Pair(scan_layers=scan_layers, max_seq_len=64, decode_chunk=16)
    pair.start()
    # row 1 steps on from 13 over its own prefilled rows (the rest masked)
    _prefill_and_steps(pair, np.random.default_rng(0), 21, 6, at=[21, 13])


@pytest.mark.parametrize("kv_len", [True, False], ids=["host_bound", "device_bound"])
def test_multi_chunk_reads(kv_len):
    """decode_chunk=16 over a 64-slot cache: prefill 40 (3 chunks), then steps
    that cross into the 4th chunk. Without a host bound the forward reads
    the device's."""
    pair = Pair(max_seq_len=64, decode_chunk=16)
    pair.start()
    _prefill_and_steps(pair, np.random.default_rng(1), 40, 10, kv_len=kv_len)


def test_packed_prefill_and_continuation():
    """A packed prompt (segments restarting positions) prefills in one pass;
    single-token steps without segment ids extend each row's last segment."""
    pair = Pair(max_seq_len=64, decode_chunk=16)
    pair.start(packed=True)
    rng = np.random.default_rng(2)
    t = 24
    seg = np.zeros((B, t), np.int32)
    seg[:, 10:] = 1
    seg[1, 17:] = 2
    pos = np.zeros((B, t), np.int32)
    for b in range(B):
        for s in np.unique(seg[b]):
            where = np.where(seg[b] == s)[0]
            pos[b, where] = np.arange(len(where))
    pair.call(_tokens(rng, t), pos, seg, kv_len=t)
    for i in range(5):
        pair.call(_tokens(rng, 1), pos[:, -1:] + 1 + i, kv_len=t + i + 1)
    assert pair.cache.seg is not None and int(pair.cache.seg[1, t + 4]) == 2


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "no_scan"])
def test_paged_shuffled_page_tables(scan_layers):
    """Each row's logical pages map to shuffled physical pages of one pool."""
    pair = Pair(scan_layers=scan_layers, paged=True, max_seq_len=64, decode_chunk=16)
    pair.start()
    rng = np.random.default_rng(3)
    per_row = 64 // PAGE
    pages = 1 + rng.permutation(pair.tcfg.num_pages - 1)[: B * per_row].reshape(B, per_row)
    pair.set("pages", pages)
    _prefill_and_steps(pair, rng, 21, 6, at=[21, 9])


def test_overlong_write_hits_the_clamp():
    """A 4-token write at index 30 of a 32-slot cache: JAX's
    dynamic_update_slice shifts it to start at 28; so does the port."""
    pair = Pair(max_seq_len=32)
    pair.start()
    rng = np.random.default_rng(4)
    pair.call(_tokens(rng, 20), _arange(0, 20), kv_len=20)
    pair.set("index", [30, 30])
    pair.call(_tokens(rng, 4), _arange(30, 4), kv_len=34)
    assert pair.cache.index.tolist() == [34, 34]


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "no_scan"])
def test_step_from_a_jax_cache(scan_layers):
    """JAX prefills; its cache is carried over by kv_cache_from_flax; one
    decode step on each side from that same cache agrees."""
    pair = Pair(scan_layers=scan_layers, max_seq_len=64, decode_chunk=16)
    pair.start()
    rng = np.random.default_rng(5)
    t = 21
    tok, pos = _tokens(rng, t), _arange(0, t)
    _, mut = pair._apply({"params": pair.params, "cache": pair.jcache}, jnp.asarray(tok), jnp.asarray(pos))
    pair.jcache = mut["cache"]
    pair.cache = kv_cache_from_flax(jax.device_get(pair.jcache), pair.tcfg)
    assert pair.cache.k.shape == (2, B, 64, 2, 16) and pair.cache.index.tolist() == [t, t]
    pair.call(_tokens(rng, 1), _arange(t, 1), kv_len=t + 1)


def test_kv_cache_from_flax_paged():
    """A paged JAX cache comes over with its pool and page table."""
    pair = Pair(paged=True, max_seq_len=64)
    pair.start()
    pages = np.arange(1, 1 + B * 8, dtype=np.int32).reshape(B, 8)[:, ::-1]
    pair.set("pages", pages)
    cache = kv_cache_from_flax(jax.device_get(pair.jcache), pair.tcfg)
    assert cache.paged and cache.k.shape == (2, pair.tcfg.num_pages, PAGE, 2, 16)
    np.testing.assert_array_equal(cache.pages.numpy(), pages)


def test_paged_equals_dense_bit_for_bit():
    """Within the port: the same calls through a dense cache and a paged one
    (shuffled pages, page size dividing the chunk) give identical logits."""
    cfg = tt.DecoderConfig.tiny(dtype=torch.float32, max_seq_len=64, decode_chunk=16)
    model = tt.Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    paged_cfg = dataclasses.replace(cfg, decode=True, paged=True, page_size=PAGE, num_pages=2 * B * 8 + 1)
    dense = init_cache(cfg, torch.zeros((B, 1)))
    paged = init_cache(paged_cfg, torch.zeros((B, 1)))
    rng = np.random.default_rng(6)
    paged.pages.copy_(torch.from_numpy(1 + rng.permutation(2 * B * 8)[: B * 8].reshape(B, 8)))
    calls = [(_tokens(rng, 19), _arange(0, 19))] + [(_tokens(rng, 1), _arange(19 + i, 1)) for i in range(8)]
    for tok, pos in calls:
        a = model(torch.from_numpy(tok), torch.from_numpy(pos), cache=dense)
        b = model(torch.from_numpy(tok), torch.from_numpy(pos), cache=paged)
        assert torch.equal(a, b)
    assert torch.equal(dense.index, paged.index)


def test_a_bound_above_the_device_one_changes_nothing():
    """Chunks a row sees no key of leave its online-softmax state
    bit-identical: reading the whole cache gives the same logits as
    reading only what was written."""
    cfg = tt.DecoderConfig.tiny(dtype=torch.float32, max_seq_len=64, decode_chunk=16)
    model = tt.Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    caches = [init_cache(cfg, torch.zeros((B, 1))) for _ in range(2)]
    for t, start in ((10, 0), (1, 10), (1, 11)):
        tok, pos = torch.from_numpy(_tokens(rng, t)), torch.from_numpy(_arange(start, t))
        exact = model(tok, pos, cache=caches[0], kv_len=start + t)
        whole = model(tok, pos, cache=caches[1], kv_len=64)
        assert torch.equal(exact, whole)


def test_cache_path_rejects_what_jax_rejects():
    cfg = tt.DecoderConfig.tiny(dtype=torch.float32, max_seq_len=32)
    model = tt.Decoder(cfg, device="cpu")
    paged_cfg = dataclasses.replace(cfg, decode=True, paged=True, page_size=PAGE, num_pages=9)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="packed"):
        model(tok, tok, tok, cache=init_cache(paged_cfg, tok))
    with pytest.raises(NotImplementedError, match="packed"):
        init_cache(paged_cfg, tok, packed=True)
    with pytest.raises(ValueError, match="explicit positions"):
        model(tok, cache=init_cache(cfg, tok))
    with pytest.raises(ValueError, match="do not fit"):
        model(torch.zeros((1, 40), dtype=torch.int32), torch.zeros((1, 40), dtype=torch.int32),
              cache=init_cache(cfg, tok))
