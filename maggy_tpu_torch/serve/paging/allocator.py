"""Host-side block allocator and per-slot page table for the paged KV cache.

A copy of :mod:`maggy_tpu.serve.paging.allocator`.

The allocator owns the physical page id space ``[0, num_pages)``. Page
``SCRATCH_PAGE`` (0) is reserved: unallocated page-table entries point at it
and masked/inactive device writes are routed there, so its content is
garbage by design and nothing ever reads it as valid. All other pages move
between exactly three states:

* **free** — on the free list, refcount 0;
* **owned** — refcount 1, exactly one request's page list holds it;
* **shared** — refcount >= 2, a prefix-aliased page held by several page
  lists. Shared pages are read-only by contract: the engine only writes a
  page while it is owned (admission writes fresh pages; decode writes the
  tail page past ``plen``, which aliasing can never cover — see
  ``docs/serving.md`` "Paged KV cache"). ``release`` decrements and frees
  at zero, so the last sharer's eviction reclaims the page.

Invariants (the property tests in ``tests/test_paged_kv.py`` hammer these):
``alloc`` is atomic (all-or-nothing under :class:`OutOfPagesError`), a page
is never double-freed, never on the free list while referenced, and
``pages_free + pages_referenced == num_pages - 1`` always.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# physical page 0: garbage sink for unallocated table entries and masked
# writes; never allocated, never read as valid
SCRATCH_PAGE = 0


class OutOfPagesError(RuntimeError):
    """The pool cannot satisfy an allocation; the scheduler's response is
    backpressure (queued admissions wait) or preemption (decode growth
    evicts the youngest request) — never a failed request."""


class BlockAllocator:
    """Free-list allocator over ``num_pages`` fixed-size pages with
    per-page reference counts (prefix aliasing shares pages)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page {SCRATCH_PAGE} is reserved), "
                f"got {num_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-used first (their
        # content is about to be fully overwritten anyway, and temporal
        # locality keeps the hot working set small)
        self._free: List[int] = list(range(self.num_pages - 1, SCRATCH_PAGE, -1))
        self._refs: Dict[int, int] = {}
        # page -> last-access generation (engine decode-step clock), stamped
        # host-side by ``touch`` on the admit/prepare paths — the heat signal
        # the tiering eviction ranking reads. Entries exist only for
        # referenced pages; a page freed is a page forgotten.
        # guarded-by: the engine lock (all allocator mutation already is)
        self._last_access: Dict[int, int] = {}
        # cumulative counters (monotonic; bench/stats)
        self.allocs = 0
        self.shares = 0

    # ------------------------------------------------------------------ state

    @property
    def pages_total(self) -> int:
        """Allocatable pages (the scratch page is not part of the budget)."""
        return self.num_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages currently referenced by more than one page list."""
        return sum(1 for n in self._refs.values() if n >= 2)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    # ------------------------------------------------------------------ moves

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh pages (refcount 1 each), atomically — on
        :class:`OutOfPagesError` nothing was taken."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfPagesError(
                f"need {n} page(s), {len(self._free)} free "
                f"of {self.pages_total}"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.allocs += n
        return out

    def share(self, pages: Sequence[int]) -> None:
        """Alias already-allocated pages into another page list
        (refcount += 1). Sharing a free or scratch page is a bug."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p == SCRATCH_PAGE or p not in self._refs:
                raise ValueError(f"share of unallocated page {p}")
        for p in pages:
            self._refs[p] += 1
        self.shares += len(pages)

    def release(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; pages reaching refcount 0 return to
        the free list. Returns how many were actually freed. Double-free
        (releasing a page no list holds) raises."""
        freed = 0
        for p in (int(p) for p in pages):
            refs = self._refs.get(p)
            if refs is None:
                raise ValueError(f"double free of page {p}")
            if refs == 1:
                del self._refs[p]
                self._last_access.pop(p, None)
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = refs - 1
        return freed

    # ------------------------------------------------------------------- heat

    def touch(self, pages: Sequence[int], gen: int) -> None:
        """Stamp ``pages`` as accessed at generation ``gen`` (the engine's
        decode-step counter). Host dict stores only — zero device cost on
        the admit/prepare hot paths. Touching a free page is ignored (a
        release can race a stale caller list by design)."""
        gen = int(gen)
        refs = self._refs
        la = self._last_access
        for p in pages:
            p = int(p)
            if p in refs:
                la[p] = gen

    def heat_buckets(
        self, gen: int, hot_age: int = 8, warm_age: int = 64
    ) -> Dict[str, int]:
        """Classify every referenced page by last-access age in generations:
        ``age <= hot_age`` hot, ``<= warm_age`` warm, else cold. Pages
        allocated but never touched count as cold (no stamp == no access)."""
        gen = int(gen)
        hot = warm = cold = 0
        la = self._last_access
        for p in self._refs:
            last = la.get(p)
            age = gen - last if last is not None else warm_age + 1
            if age <= hot_age:
                hot += 1
            elif age <= warm_age:
                warm += 1
            else:
                cold += 1
        return {"hot": hot, "warm": warm, "cold": cold}

    def coldest(
        self, n: Optional[int] = None, include_shared: bool = False
    ) -> List[int]:
        """Referenced pages ranked coldest-first (oldest last-access
        generation; never-touched pages first of all) — the eviction-candidate
        ordering the host-DRAM tiering consumes. Ties break on page id for
        determinism.

        Shared pages (refcount >= 2) are EXCLUDED by default: a
        prefix-aliased page is live working set for every request holding
        it, however stale its heat stamp looks — spilling one out from
        under an active sharer would corrupt a stream that never chose to
        be evicted. ``include_shared=True`` restores the raw ranking for
        observability callers that want the full heat picture."""
        la = self._last_access
        refs = self._refs
        pages = (
            refs
            if include_shared
            else (p for p, c in refs.items() if c < 2)
        )
        ranked = sorted(pages, key=lambda p: (la.get(p, -1), p))
        return ranked if n is None else ranked[: int(n)]

    # ---------------------------------------------------------- fragmentation

    def fragmentation(self) -> Dict[str, float]:
        """Free-run-length distribution: how contiguous the free pool is.
        ``frag_ratio`` is 0.0 when all free pages form one run (or none are
        free) and approaches 1.0 as the free space shatters into single-page
        runs — a threshold alert rule watches this via ``serve.fragmentation``.

        The alias-aware pair sizes what tiering could actually reclaim:
        ``pages_pinned_shared`` (refcount >= 2 — never spill-eligible while
        any sharer is active) and ``pages_reclaimable`` (refcount 1 — one
        release or spill away from free). They always sum with the free
        count to the whole pool."""
        free = sorted(self._free)
        shared = sum(1 for c in self._refs.values() if c >= 2)
        extra = {
            "pages_pinned_shared": shared,
            "pages_reclaimable": len(self._refs) - shared,
        }
        if not free:
            return {"free_runs": 0, "largest_run": 0, "frag_ratio": 0.0, **extra}
        runs = 1
        largest = cur = 1
        for prev, nxt in zip(free, free[1:]):
            if nxt == prev + 1:
                cur += 1
            else:
                runs += 1
                cur = 1
            if cur > largest:
                largest = cur
        return {
            "free_runs": runs,
            "largest_run": largest,
            "frag_ratio": round(1.0 - largest / len(free), 4),
            **extra,
        }

    def check_invariants(self) -> None:
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages on the free list"
        assert SCRATCH_PAGE not in free and SCRATCH_PAGE not in self._refs
        assert not (free & set(self._refs)), "page both free and referenced"
        assert len(free) + len(self._refs) == self.pages_total
        assert all(n >= 1 for n in self._refs.values())
        assert set(self._last_access) <= set(self._refs), (
            "heat stamp on a non-referenced page"
        )
        frag = self.fragmentation()
        assert (frag["largest_run"] == 0) == (not self._free)
        assert frag["largest_run"] <= len(self._free)
        assert 0.0 <= frag["frag_ratio"] <= 1.0
        # alias consistency: spill candidates never include a shared page,
        # and the reclaimable/pinned split tiles the referenced set
        shared = {p for p, c in self._refs.items() if c >= 2}
        assert not (set(self.coldest()) & shared), (
            "shared page ranked spill-eligible"
        )
        assert (
            frag["pages_pinned_shared"] + frag["pages_reclaimable"]
            == len(self._refs)
        )

    def stats(self) -> Dict[str, int]:
        return {
            "pages_total": self.pages_total,
            "pages_free": self.pages_free,
            "pages_shared": self.pages_shared,
            "page_size": self.page_size,
            "page_allocs": self.allocs,
            "page_shares": self.shares,
        }


class PageTable:
    """Host mirror of the device page-table cache variable: one ordered
    page list per slot, flattened into the ``[num_slots, max_pages]`` int32
    array the compiled decode step gathers through. Unused entries hold
    ``SCRATCH_PAGE``. The engine pushes ``table`` to the device whenever
    ``dirty`` (admission, release, growth) — the mirror is the single
    source of truth."""

    def __init__(self, num_slots: int, max_pages: int):
        self.num_slots = int(num_slots)
        self.max_pages = int(max_pages)
        self.table = np.full(
            (self.num_slots, self.max_pages), SCRATCH_PAGE, np.int32
        )
        self._lists: Dict[int, List[int]] = {}
        self.dirty = True  # first push seeds the device copy

    def pages(self, slot: int) -> List[int]:
        return list(self._lists.get(slot, ()))

    def count(self, slot: int) -> int:
        return len(self._lists.get(slot, ()))

    def assign(self, slot: int, pages: Sequence[int]) -> None:
        pages = [int(p) for p in pages]
        if len(pages) > self.max_pages:
            raise ValueError(
                f"slot {slot}: {len(pages)} pages > max_pages {self.max_pages}"
            )
        self._lists[slot] = pages
        self.table[slot, :] = SCRATCH_PAGE
        self.table[slot, : len(pages)] = pages
        self.dirty = True

    def grow(self, slot: int, page: int) -> None:
        """Append one page to a slot's list (decode crossed a boundary)."""
        lst = self._lists.setdefault(slot, [])
        if len(lst) >= self.max_pages:
            raise ValueError(f"slot {slot} already holds max_pages")
        self.table[slot, len(lst)] = int(page)
        lst.append(int(page))
        self.dirty = True

    def clear(self, slot: int) -> List[int]:
        """Drop a slot's list (release/preempt); returns the pages so the
        caller can hand them back to the allocator. The table row is zeroed
        so a released row's masked device writes land on the scratch page,
        never on a re-allocated one."""
        pages = self._lists.pop(slot, [])
        self.table[slot, :] = SCRATCH_PAGE
        self.dirty = True
        return pages

    def row(self, slot: int) -> np.ndarray:
        return self.table[slot].copy()

    def check_invariants(self, allocator: BlockAllocator) -> None:
        seen: Dict[int, int] = {}
        for slot, pages in self._lists.items():
            assert len(set(pages)) == len(pages), f"slot {slot} repeats a page"
            row = self.table[slot]
            assert list(row[: len(pages)]) == pages
            assert all(p == SCRATCH_PAGE for p in row[len(pages):])
            for p in pages:
                seen[p] = seen.get(p, 0) + 1
        for p, n in seen.items():
            assert allocator.refcount(p) == n, (
                f"page {p}: {n} list reference(s) vs refcount "
                f"{allocator.refcount(p)}"
            )
