"""Per-worker device memory ledger: named accounts reconciled against the card.

A copy of :mod:`maggy_tpu.telemetry.memtrack`'s :class:`MemoryLedger` and
:func:`array_bytes`. Allocation sites register **named accounts** — the
serving engine's ``params``, ``kv_pages`` and ``workspace`` — each a byte
figure computed from its own tensors; :meth:`MemoryLedger.reconcile`
compares their sum with what the CUDA caching allocator's devices report
(``torch.cuda.mem_get_info``), or, where no card is initialised, with a
deterministic simulation: the account sum plus a fixed
:data:`SIM_UNATTRIBUTED_FRAC` overhead, against a pool of
:attr:`MemoryLedger.sim_limit_bytes` (4x used unless set).

Reconciliation must *never* crash the loop that ticks it: every device probe
is wrapped, and a mismatch is a gauge (``mem.unattributed``), not an error.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# CPU-sim runtime overhead: the deterministic stand-in for what a real
# runtime allocates beyond the registered accounts. 5% keeps the account sum
# within a 10% reconciliation contract.
SIM_UNATTRIBUTED_FRAC = 0.05

# headroom below this fraction of the pool counts the tick as a miss for
# the alert.hbm_headroom burn rule
DEFAULT_LOW_HEADROOM_PCT = 0.10


def device_memory() -> Optional[Tuple[int, int]]:
    """``(bytes_in_use, bytes_limit)`` summed over the CUDA devices, or None
    when CUDA is absent or not initialised (a probe never starts a context)."""
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        used = limit = 0
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            used += int(total - free)
            limit += int(total)
        if limit > 0:
            return used, limit
    except Exception:  # noqa: BLE001 - a probe failure must not kill the tick
        pass
    return None


class MemoryLedger:
    """Named byte accounts + reconciliation against reported device memory.

    Registration (``register``/``adjust``/``unregister``) happens from
    whatever thread owns the allocation (trainer setup, engine admit,
    prefetcher construction); :meth:`tick` runs on the owner's metrics
    thread — so the account table is lock-guarded.
    """

    def __init__(self, low_headroom_pct: float = DEFAULT_LOW_HEADROOM_PCT):
        self._lock = threading.Lock()
        self._accounts: Dict[str, int] = {}  # guarded-by: _lock
        self.low_headroom_pct = float(low_headroom_pct)
        # cumulative low-water tick counters (the burn-rule pair); written
        # only by the tick thread, read via snapshots
        self._headroom_ok = 0  # guarded-by: _lock
        self._headroom_miss = 0  # guarded-by: _lock
        # CPU-sim pool size; None = 4x reported-used (healthy headroom).
        # Pressure tests shrink this to drive headroom under the low-water
        # mark deterministically.
        self.sim_limit_bytes: Optional[int] = None

    # -------------------------------------------------------------- accounts

    def register(self, name: str, nbytes: int) -> None:
        """Set account ``name`` to ``nbytes`` (idempotent — re-registering
        an account replaces its figure; allocation sites call this on every
        (re)build so a reconfigure never double-counts)."""
        with self._lock:
            self._accounts[str(name)] = max(0, int(nbytes))

    def adjust(self, name: str, delta: int) -> None:
        """Add ``delta`` bytes to an account (clamped at zero)."""
        with self._lock:
            cur = self._accounts.get(str(name), 0)
            self._accounts[str(name)] = max(0, cur + int(delta))

    def unregister(self, name: str) -> None:
        with self._lock:
            self._accounts.pop(str(name), None)

    def accounts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._accounts)

    def accounted_bytes(self) -> int:
        with self._lock:
            return sum(self._accounts.values())

    # ----------------------------------------------------------- reconcile

    def reconcile(self) -> Dict[str, Any]:
        """One reconciliation pass: account sum vs reported device memory
        (or the deterministic CPU-sim). Pure read — no counters move."""
        accounted = self.accounted_bytes()
        reported = device_memory()
        if reported is not None:
            used, limit = reported
            source = "device"
        else:
            used = int(accounted * (1.0 + SIM_UNATTRIBUTED_FRAC))
            limit = self.sim_limit_bytes
            if limit is None:
                limit = max(1, used) * 4
            source = "sim"
        limit = max(int(limit), 1)
        used = min(int(used), limit)
        free = limit - used
        return {
            "source": source,
            "hbm_used": used,
            "hbm_free": free,
            "hbm_limit": limit,
            "headroom_pct": round(free / limit, 4),
            "accounted": accounted,
            "unattributed": max(0, used - accounted),
            "accounts": self.accounts(),
        }

    def tick(self, store=None, telemetry=None, now: Optional[float] = None) -> Dict[str, Any]:  # thread-entry — ticked from the owning scheduler/trainer metrics loop
        """Reconcile and export: gauges into the time-series ``store`` and
        the ``telemetry`` recorder, plus the cumulative headroom ok/miss
        counter pair the ``alert.hbm_headroom`` burn rule reads. Never
        raises — capacity observability must not sink the loop it rides."""
        try:
            rec = self.reconcile()
        except Exception:  # noqa: BLE001 - reconcile must never kill the tick
            return {}
        with self._lock:
            if rec["headroom_pct"] < self.low_headroom_pct:
                self._headroom_miss += 1
            else:
                self._headroom_ok += 1
            ok, miss = self._headroom_ok, self._headroom_miss
        rec["headroom_ok"] = ok
        rec["headroom_miss"] = miss
        try:
            if telemetry is not None:
                telemetry.gauge("mem.hbm_used", float(rec["hbm_used"]))
                telemetry.gauge("mem.hbm_free", float(rec["hbm_free"]))
                telemetry.gauge("mem.headroom_pct", rec["headroom_pct"])
                telemetry.gauge("mem.unattributed", float(rec["unattributed"]))
            if store is not None and now is not None:
                gauges = {
                    "mem.hbm_used": float(rec["hbm_used"]),
                    "mem.hbm_free": float(rec["hbm_free"]),
                    "mem.headroom_pct": rec["headroom_pct"],
                    "mem.unattributed": float(rec["unattributed"]),
                }
                for name, nbytes in rec["accounts"].items():
                    gauges[f"mem.account.{name}"] = float(nbytes)
                store.ingest(
                    now,
                    gauges=gauges,
                    counters={"mem.headroom_ok": ok, "mem.headroom_miss": miss},
                )
        except Exception:  # noqa: BLE001 - export must never kill the tick
            pass
        return rec

    def snapshot(self) -> Dict[str, Any]:
        """SSTATS-ready view (no counter movement)."""
        rec = self.reconcile()
        with self._lock:
            rec["headroom_ok"] = self._headroom_ok
            rec["headroom_miss"] = self._headroom_miss
        return rec


def array_bytes(tree: Any) -> int:
    """Total bytes of every tensor or array in a (possibly nested) structure
    of dicts, lists, tuples and dataclasses (such as a ``KVCache``) — the
    helper allocation sites use to size an account. A tensor is counted
    once however often it appears."""
    seen = set()
    dtensor = sys.modules.get("torch.distributed.tensor")  # loaded wherever a DTensor exists

    def walk(node) -> int:
        if dtensor is not None and isinstance(node, dtensor.DTensor):
            node = node.to_local()  # what this rank holds of a parameter laid out on a mesh
        if isinstance(node, torch.Tensor):
            key = (node.device, node.data_ptr(), node.numel(), node.dtype)
            if key in seen:
                return 0
            seen.add(key)
            return node.numel() * node.element_size()
        if isinstance(node, np.ndarray):
            return int(node.nbytes)
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(walk(v) for v in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return sum(walk(getattr(node, f.name)) for f in dataclasses.fields(node))
        return 0

    return walk(tree)
