"""Paged KV cache: fixed-size pages + a host-side block allocator.

A copy of :mod:`maggy_tpu.serve.paging`.

The slot cache (docs/serving.md "Slots and the compiled programs") reserves
``max_seq_len`` rows per slot, so HBM — not compute — caps concurrency. This
package decouples them: the engine's K/V storage becomes a flat *pool* of
``num_pages`` fixed-size pages and each slot holds an ordered *page list*;
a per-slot page-table row (``[max_pages]`` int32, a cache variable the
compiled decode step gathers through) maps logical positions to physical
pages. Consequences, in order of importance:

* **Concurrency tracks actual lengths.** A request occupies
  ``ceil(tokens/page_size)`` pages, not ``max_seq_len`` rows, so the same
  HBM admits several times more typical-length requests (``bench.py
  extra.paging`` gates ≥2x at a fixed simulated budget).
* **Prefix sharing is aliasing, not copying.** Admitting a request whose
  prompt shares a resident prefix points its page-table entries at the
  source's pages (ref-counted; ``serve.pages_shared``) instead of copying
  KV rows. Pages are copy-on-write by construction: writes only ever land
  past ``plen`` in privately-owned tail pages, so a shared page is never
  written in place.
* **Preemption is cheap.** Evicting a request frees its pages and retains
  only host state (prompt + generated tokens); re-admission re-prefills
  and continues byte-identically (docs/serving.md "Preemption").

Everything here is pure host-side bookkeeping (stdlib + numpy); the device
half lives in ``models/transformer.py`` (``_paged_cached_attention``) and
the engine's paged admit programs.
"""

from maggy_tpu_torch.serve.paging.allocator import (  # noqa: F401
    SCRATCH_PAGE,
    BlockAllocator,
    OutOfPagesError,
    PageTable,
)

__all__ = [
    "BlockAllocator",
    "OutOfPagesError",
    "PageTable",
    "SCRATCH_PAGE",
]
