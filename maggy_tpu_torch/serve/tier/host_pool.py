"""Host-DRAM KV page pool — the second tier under the device page pool.

The port's copy of :mod:`maggy_tpu.serve.tier.host_pool`. The engine's
:class:`~maggy_tpu_torch.serve.paging.BlockAllocator` owns the device pages;
this pool owns their host-side shadow. KV pages cross the boundary as CPU
``torch`` tensors, which hold any dtype (bf16 has no numpy counterpart), so
bytes survive the round trip; keyed by pack: a *resume pack* (``rid:<id>``)
holds a preempted stream's pages for cheap swap-in, a *prefix pack*
(``px:<digest>``) holds a released prompt's full pages for cross-request
reuse.

Storage is one host buffer per KV leaf, ``[H, *block]``, all leaves sharing
ONE page-id space, pinned when ``pin_memory`` is set (the engine sets it on
a CUDA card: a spill is then a direct device-to-host copy into the buffer's
rows). Blocks may arrive on any device, or as numpy arrays; a run of
consecutive page ids is written with one copy. Capacity is a page budget
(``serve.tier_host_pages``): a put that does not fit evicts
least-recently-used packs; a put larger than the whole budget is refused
(the caller falls back to plain re-prefill). Shrinking the budget evicts
immediately but keeps the buffers — host memory is reclaimed lazily, never
mid-serve. The buffers grow geometrically (at least double, at most the
budget), where the JAX pool grows each to the exact high-water mark on
every put and so recopies the whole buffer for each new page.

Written by the scheduler thread (spill at preempt/release, fill at admit)
and read by stats/RPC threads, so the directory is lock-guarded. The
``host_pool_slow`` chaos seam injects swap-in latency in :meth:`get` —
outside the lock, like every chaos sleep.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from maggy_tpu_torch import telemetry
from maggy_tpu_torch.core import lockdebug
from maggy_tpu_torch.resilience import chaos as chaos_mod


def _runs(ids: List[int]) -> List[Tuple[int, int, int]]:
    """``(position in ids, first id, length)`` of each run of consecutive ids."""
    out: List[Tuple[int, int, int]] = []
    for i, p in enumerate(ids):
        if out and out[-1][1] + out[-1][2] == p:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((i, p, 1))
    return out


class HostPagePool:
    """Bounded LRU pool of host-resident KV page packs."""

    def __init__(self, capacity_pages: int, telemetry_recorder=None, pin_memory: bool = False):
        self.telemetry = telemetry_recorder or telemetry.get()
        self.pin_memory = bool(pin_memory)
        self._lock = lockdebug.lock("tier.host_pool")
        self._capacity = max(0, int(capacity_pages))  # guarded-by: _lock
        # per-leaf host buffers, one shared page-id space; rows are grown
        # on demand past the minted high-water mark  # guarded-by: _lock
        self._buffers: Dict[str, torch.Tensor] = {}
        self._free: List[int] = []  # recycled page ids  # guarded-by: _lock
        self._next_id = 0  # mint cursor  # guarded-by: _lock
        # pack directory: key -> {"pages", "meta", "seq"}  # guarded-by: _lock
        self._packs: Dict[str, Dict[str, Any]] = {}
        self._seq = 0  # LRU clock  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.puts = 0  # guarded-by: _lock
        self.gets = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock

    # --------------------------------------------------------------- internal

    def _used(self) -> int:  # guarded-by: _lock
        return self._next_id - len(self._free)

    def _evict_lru(self) -> bool:  # guarded-by: _lock
        """Drop the least-recently-touched pack; False when empty."""
        if not self._packs:
            return False
        key = min(self._packs.items(), key=lambda kv: kv[1]["seq"])[0]
        self._free.extend(self._packs.pop(key)["pages"])
        self.evictions += 1
        return True

    def _mint(self, n: int) -> List[int]:  # guarded-by: _lock
        """Claim ``n`` page ids (recycled first, lowest first so a pack's
        pages tend to form one run), growing buffers to fit."""
        self._free.sort(reverse=True)
        ids = [self._free.pop() for _ in range(min(n, len(self._free)))]
        while len(ids) < n:
            ids.append(self._next_id)
            self._next_id += 1
        high = max(ids) + 1
        for ks, buf in self._buffers.items():
            rows = buf.shape[0]
            if rows < high:
                grown = torch.empty((max(high, min(2 * rows, self._capacity)),) + tuple(buf.shape[1:]),
                                    dtype=buf.dtype, pin_memory=self.pin_memory)
                grown[:rows].copy_(buf)
                self._buffers[ks] = grown
        return ids

    # ------------------------------------------------------------------- API

    def put(self, key: str, blocks: Dict[str, Any], meta: Dict[str, Any]) -> bool:  # thread-entry — scheduler loop spills, stats threads read
        """Spill one pack: ``blocks`` maps cache-leaf keys to ``[n, *block]``
        page stacks (tensors on any device, or numpy arrays; all leaves the
        same ``n``). Replaces any pack already under ``key``; evicts LRU
        packs to fit; False when ``n`` exceeds the whole budget (caller keeps
        the re-prefill fallback)."""
        if not blocks:
            return False
        blocks = {ks: torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                  for ks, a in blocks.items()}
        n = next(iter(blocks.values())).shape[0]
        evicted = 0
        with self._lock:
            old = self._packs.pop(key, None)
            if old is not None:
                self._free.extend(old["pages"])
            if n > self._capacity:
                return False
            while self._used() + n > self._capacity:
                if not self._evict_lru():
                    return False
                evicted += 1
            for ks, arr in blocks.items():
                if ks not in self._buffers:
                    self._buffers[ks] = torch.empty((0,) + tuple(arr.shape[1:]), dtype=arr.dtype)
            ids = self._mint(n)
            for ks, arr in blocks.items():
                buf = self._buffers[ks]
                for i, first, length in _runs(ids):
                    buf[first:first + length].copy_(arr[i:i + length])
            self._seq += 1
            self._packs[key] = {
                "pages": ids, "meta": dict(meta), "seq": self._seq,
            }
            self.puts += 1
        if evicted:
            self.telemetry.count("tier.host_evictions", evicted)
        return True

    def get(self, key: str) -> Optional[Tuple[Dict[str, torch.Tensor], Dict[str, Any]]]:
        """Fill one pack back out: ``(blocks, meta)`` copies, or None. A hit
        refreshes the pack's LRU recency; the pack stays resident (drop is
        the caller's call — a resume pack dies on successful admit, a prefix
        pack serves many requests)."""
        with self._lock:
            pack = self._packs.get(key)
            if pack is None:
                self.misses += 1
                return None
            self._seq += 1
            pack["seq"] = self._seq
            self.gets += 1
            ids = list(pack["pages"])
            runs = _runs(ids)
            if len(runs) == 1:
                blocks = {ks: buf[ids[0]:ids[0] + len(ids)].clone() for ks, buf in self._buffers.items()}
            else:
                index = torch.tensor(ids, dtype=torch.long)
                blocks = {ks: buf.index_select(0, index) for ks, buf in self._buffers.items()}
            meta = dict(pack["meta"])
        ch = chaos_mod.get()
        if ch is not None:
            delay = ch.host_pool_slow()
            if delay > 0:
                time.sleep(delay)  # outside the lock, like every chaos sleep
        return blocks, meta

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._packs

    def drop(self, key: str) -> None:
        with self._lock:
            pack = self._packs.pop(key, None)
            if pack is not None:
                self._free.extend(pack["pages"])

    def keys(self) -> List[str]:  # thread-entry — SSTATS threads enumerate packs
        with self._lock:
            return list(self._packs)

    def set_capacity(self, capacity_pages: int) -> None:
        """Autopilot seam (``serve.tier_host_pages``, safe-live): shrink
        evicts LRU packs immediately; growth takes effect on the next put."""
        with self._lock:
            self._capacity = max(0, int(capacity_pages))
            while self._used() > self._capacity:
                if not self._evict_lru():
                    break

    def stats(self) -> Dict[str, Any]:  # thread-entry — SSTATS/monitor threads
        with self._lock:
            used = self._used()
            return {
                "host_pages_total": self._capacity,
                "host_pages_used": used,
                "host_pages_free": max(0, self._capacity - used),
                "host_bytes": sum(b.numel() * b.element_size() for b in self._buffers.values()),
                "resident_packs": len(self._packs),
                "host_evictions": self.evictions,
                "puts": self.puts,
                "gets": self.gets,
                "misses": self.misses,
            }
