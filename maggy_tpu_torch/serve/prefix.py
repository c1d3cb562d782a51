"""Prefix index over resident prompts — the lookup half of prefix-KV reuse.

A copy of :mod:`maggy_tpu.serve.prefix`.

Real serving traffic shares long prompt prefixes (the system prompt is
identical across most requests), so a new request usually arrives while a
slot holding the *same opening tokens* is still resident. The engine can
then admit it by copying the already-computed KV rows instead of
re-prefilling them (docs/fleet.md "Prefix reuse"); this module answers the
host-side question "which resident slot shares the longest prefix with this
prompt, and how long is it?" in O(log max_len) hash probes instead of an
O(slots · len) scan.

Mechanics: every resident prompt is indexed under the hash of each of its
power-of-two-length prefixes (8, 16, 32, …— the same bucket ladder the
prefill compiler uses, so index granularity matches compile granularity).
``match()`` probes descending bucket lengths, verifies the hit against the
actual stored prompt (hash collisions can suggest, never lie), then extends
the verified bucket match token-by-token to the exact longest common
prefix. Newest insertion wins a bucket — recency is the better reuse bet
under churn.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

# smallest indexed prefix; matches engine.MIN_PREFILL_BUCKET so a reused
# prefix always spans at least one full prefill bucket
MIN_PREFIX = 8


def _buckets(n: int, lo: int = MIN_PREFIX) -> List[int]:
    """Power-of-two prefix lengths <= n, ascending (8, 16, ... <= n)."""
    out = []
    b = lo
    while b <= n:
        out.append(b)
        b *= 2
    return out


class PrefixIndex:
    """slot -> prompt registry with hashed-prefix lookup.

    Host-side only and single-threaded by contract (the scheduler thread owns
    admission); the engine mirrors its slot lifecycle into it — ``insert`` on
    admit, ``remove`` on release.
    """

    def __init__(self, min_len: int = MIN_PREFIX):
        self.min_len = max(1, int(min_len))
        self._prompts: Dict[int, Tuple[int, ...]] = {}
        # hash(bucket-length prefix) -> slot that most recently wrote it
        self._by_hash: Dict[Tuple[int, int], int] = {}
        # per-slot residency metadata for the capacity view: when the prompt
        # became resident, when it last served a reuse hit, and how often —
        # same single-threaded contract as the index itself
        self._meta: Dict[int, Dict[str, int]] = {}
        # KV bytes one resident token pins (the engine sets this from its
        # cache geometry; 4 = raw int32 token ids when nothing better is known)
        self.bytes_per_token = 4

    def insert(self, slot: int, prompt: List[int], gen: int = 0) -> None:
        tokens = tuple(int(t) for t in prompt)
        self._prompts[slot] = tokens
        self._meta[slot] = {"inserted_gen": int(gen), "last_hit_gen": int(gen), "hits": 0}
        for b in _buckets(len(tokens), self.min_len):
            self._by_hash[(b, hash(tokens[:b]))] = slot

    def remove(self, slot: int) -> None:
        tokens = self._prompts.pop(slot, None)
        self._meta.pop(slot, None)
        if tokens is None:
            return
        for b in _buckets(len(tokens), self.min_len):
            key = (b, hash(tokens[:b]))
            if self._by_hash.get(key) == slot:
                del self._by_hash[key]
        # a dropped bucket may still be owned by an older resident sharing
        # the prefix (system prompts collide by design) — re-point it so a
        # short-lived request's release can't orphan the long-lived anchor
        for other, resident in self._prompts.items():
            for b in _buckets(len(resident), self.min_len):
                self._by_hash.setdefault((b, hash(resident[:b])), other)

    def match(
        self, prompt: List[int], gen: Optional[int] = None
    ) -> Optional[Tuple[int, int]]:
        """``(slot, lcp_len)`` of the resident prompt sharing the longest
        common prefix with ``prompt`` (>= ``min_len``), or None.

        The probe walks bucket lengths longest-first; the first verified hit
        is extended by direct comparison, so the returned length is the exact
        LCP with that slot — which may exceed the bucket that found it. A hit
        bumps the slot's residency recency (``gen`` when given) — the signal
        prefix-affinity dispatch and tiering eviction rank on.
        """
        tokens = tuple(int(t) for t in prompt)
        for b in reversed(_buckets(len(tokens), self.min_len)):
            slot = self._by_hash.get((b, hash(tokens[:b])))
            if slot is None:
                continue
            resident = self._prompts.get(slot)
            if resident is None or resident[:b] != tokens[:b]:
                continue  # hash collision or stale entry: keep probing
            lcp = b
            limit = min(len(resident), len(tokens))
            while lcp < limit and resident[lcp] == tokens[lcp]:
                lcp += 1
            meta = self._meta.get(slot)
            if meta is not None:
                meta["hits"] += 1
                if gen is not None:
                    meta["last_hit_gen"] = int(gen)
            return slot, lcp
        return None

    def resident(self) -> Dict[int, Tuple[int, ...]]:
        return dict(self._prompts)

    # -------------------------------------------------------------- residency

    @staticmethod
    def digest(tokens: Tuple[int, ...], head: int = 16) -> str:
        """Stable 8-hex digest of a prompt's opening tokens — identical for
        the same prefix on every replica/process (unlike ``hash``), so the
        fleet residency view can group residents across workers."""
        data = ",".join(str(int(t)) for t in tokens[:head]).encode()
        return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"

    def residency_stats(
        self, gen: Optional[int] = None, top: int = 4
    ) -> Dict[str, Any]:
        """Aggregate residency view for SSTATS: how much KV the resident
        prompts pin and which prefixes are the hottest reuse anchors."""
        tokens_total = sum(len(t) for t in self._prompts.values())
        rows = []
        for slot, toks in self._prompts.items():
            meta = self._meta.get(slot) or {}
            row = {
                "digest": self.digest(toks),
                "slot": slot,
                "tokens": len(toks),
                "bytes": len(toks) * self.bytes_per_token,
                "hits": meta.get("hits", 0),
            }
            if gen is not None:
                row["age"] = int(gen) - meta.get("last_hit_gen", 0)
            rows.append(row)
        rows.sort(key=lambda r: (-r["hits"], -r["tokens"], r["digest"]))
        return {
            "resident_prefixes": len(self._prompts),
            "resident_tokens": tokens_total,
            "resident_bytes": tokens_total * self.bytes_per_token,
            "top": rows[: int(top)],
        }
