"""Tiering policy: WHEN to spill KV out of HBM, and the spill/fill ledger.

A copy of :mod:`maggy_tpu.serve.tier.tiering`.

The mechanism lives elsewhere — the engine captures/restores pages through
:class:`~maggy_tpu_torch.serve.tier.HostPagePool`, the scheduler picks victims —
this class is the decision layer and the accounting the ``tier.*``
telemetry reads. Two spill triggers share it:

* **Event spills** are free rides on lifecycle edges: a preemption victim's
  pages are captured before release (resume pack), a released prompt's full
  pages become a prefix pack. No policy question — the pages were leaving
  HBM anyway.
* **Pressure spills** are proactive: when the memory ledger's
  ``mem.hbm_headroom_pct`` drops under the low-water mark
  (``serve.tier_low_water_pct``, an autopilot knob), the scheduler's 1 Hz
  metrics tick asks :meth:`should_spill` and preempts-with-spill the
  coldest low-class stream — freeing pool pages *before* an admission hits
  ``OutOfPagesError`` and has to preempt under the gun. The autopilot's
  memory-bound playbook grows the host budget ahead of shrinking
  ``serve.max_pages_per_req`` (spill before preempt — docs/autotune.md).

Counters move from the scheduler thread and are read by stats/RPC threads,
so they sit behind a lock (pinned in ``tools/check_concurrency.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from maggy_tpu_torch.core import lockdebug

# default low-water mark: pressure-spill when HBM headroom drops under 5%
# (below the ledger's 10% alert mark, so the alert fires first and the
# spill is the remediation the playbook narrates)
DEFAULT_LOW_WATER_PCT = 0.05


class TieringPolicy:
    """Spill/fill decision + accounting for the host-DRAM KV tier."""

    def __init__(self, low_water_pct: float = DEFAULT_LOW_WATER_PCT):
        self.low_water_pct = float(low_water_pct)
        self._lock = lockdebug.lock("tier.policy")
        # cumulative spill/fill ledger, split by pack kind; exact mirror of
        # the tier.* counters so SSTATS can report without a telemetry
        # round-trip  # guarded-by: _lock
        self.spills = 0
        self.fills = 0
        self.spilled_pages = 0
        self.filled_pages = 0
        self.prefix_spills = 0
        self.prefix_fills = 0
        self.pressure_spills = 0

    def should_spill(self, headroom_pct: Optional[float]) -> bool:  # thread-entry — scheduler's 1 Hz metrics tick
        """One pressure verdict per metrics tick: True when the ledger's
        reconciled headroom sits under the low-water mark."""
        if headroom_pct is None:
            return False
        return float(headroom_pct) < self.low_water_pct

    # ---------------------------------------------------------------- ledger

    def note_spill(self, pages: int, prefix: bool = False, pressure: bool = False) -> None:
        with self._lock:
            self.spills += 1
            self.spilled_pages += int(pages)
            if prefix:
                self.prefix_spills += 1
            if pressure:
                self.pressure_spills += 1

    def note_fill(self, pages: int, prefix: bool = False) -> None:
        with self._lock:
            self.fills += 1
            self.filled_pages += int(pages)
            if prefix:
                self.prefix_fills += 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "low_water_pct": self.low_water_pct,
                "spills": self.spills,
                "fills": self.fills,
                "spilled_pages": self.spilled_pages,
                "filled_pages": self.filled_pages,
                "prefix_spills": self.prefix_spills,
                "prefix_fills": self.prefix_fills,
                "pressure_spills": self.pressure_spills,
            }
