"""Fleet prefix map: which replicas hold which prefix resident, bounded.

A copy of :mod:`maggy_tpu.serve.tier.prefixmap`.

The router already polls every replica's SSTATS, and each snapshot carries
a ``prefix_residency`` block whose top anchors are identified by the
cross-process crc32 digest (:meth:`~maggy_tpu_torch.serve.prefix.PrefixIndex.digest`).
This map folds those snapshots into one fleet view — digest → the replica
indices holding it resident — so dispatch can add an affinity bonus to
``projected_ttft_ms`` and stop prefilling the same system prompt N times
across N replicas (docs/fleet.md "Fleet-global KV").

Hash digests can collide, so the map only *suggests*: a wrong suggestion
costs one missed reuse on the chosen replica (its own prefix index
verifies against real tokens), never a wrong output.

Bounded: at most ``max_entries`` digests, LRU-evicted, so a hostile or
high-churn prefix population cannot grow router memory without limit.
Updated by the router pump (metrics tick, replica-down sweep) and read
under the router's dispatch lock — lock-guarded, pinned in
``tools/check_concurrency.py`` REQUIRED_MODELS.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, FrozenSet, Iterable, Set

from maggy_tpu_torch.core import lockdebug


class FleetPrefixMap:
    """Bounded digest -> resident-replica map fed from SSTATS snapshots."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max(1, int(max_entries))
        self._lock = lockdebug.lock("tier.prefix_map")
        # digest -> set of replica indices, LRU-ordered  # guarded-by: _lock
        self._digests: "OrderedDict[str, Set[int]]" = OrderedDict()
        # replica -> digests it contributed (for O(set) replacement when a
        # fresh snapshot or a death supersedes it)  # guarded-by: _lock
        self._by_replica: Dict[int, Set[str]] = {}

    def update(self, replica: int, digests: Iterable[str]) -> None:  # thread-entry — router pump's metrics tick
        """Replace ``replica``'s contribution with this snapshot's digests
        (residency is a point-in-time fact — anchors it no longer reports
        are gone from its HBM, so they leave the map too)."""
        fresh = {str(d) for d in digests if d}
        replica = int(replica)
        with self._lock:
            for d in self._by_replica.get(replica, set()) - fresh:
                holders = self._digests.get(d)
                if holders is not None:
                    holders.discard(replica)
                    if not holders:
                        del self._digests[d]
            for d in fresh:
                holders = self._digests.get(d)
                if holders is None:
                    self._digests[d] = {replica}
                else:
                    holders.add(replica)
                self._digests.move_to_end(d)
            self._by_replica[replica] = fresh
            while len(self._digests) > self.max_entries:
                stale, holders = self._digests.popitem(last=False)
                for r in holders:
                    self._by_replica.get(r, set()).discard(stale)

    def forget_replica(self, replica: int) -> None:  # thread-entry — router pump's down-sweep
        """A dead/quarantined replica's residents are unreachable — drop
        its contribution so affinity never routes toward a corpse."""
        self.update(int(replica), ())

    def replicas_for(self, digest: str) -> FrozenSet[int]:
        with self._lock:
            return frozenset(self._digests.get(str(digest), ()))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._digests),
                "max_entries": self.max_entries,
                "replicas": {
                    str(r): len(ds)
                    for r, ds in self._by_replica.items()
                    if ds
                },
            }
