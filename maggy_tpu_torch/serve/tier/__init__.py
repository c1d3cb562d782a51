"""Fleet-global KV: host-DRAM page tiering + prefix-affinity routing.

The port's copy of :mod:`maggy_tpu.serve.tier`; the host pool holds CPU
``torch`` tensors (pinned when the serving device is a CUDA card), so bf16
pages cross the boundary bit for bit. The fleet's router
(:mod:`maggy_tpu_torch.serve.fleet.router`) reads the prefix map.

HBM is the only KV tier a replica has by default, and prefix reuse is
per-replica — so at fleet scale the same system prompt prefills N times
across N replicas and a preempted stream pays a full re-prefill on
re-admission. This package adds the two missing layers (ROADMAP open item
4; docs/serving.md "Host-DRAM page tier", docs/fleet.md "Fleet-global KV"):

* :class:`HostPagePool` — a host-tensor page pool behind the KV-pack
  serialization seam. The engine spills cold KV pages (preempted streams,
  released prefix anchors) into it and pages them back on demand at
  admission, so a preemption's re-prefill becomes a cheap swap-in that is
  byte-identical through the existing resume seam.
* :class:`TieringPolicy` — the spill/fill decision layer, driven off the
  memory ledger's ``mem.headroom_pct``: when headroom crosses the low-water
  mark the scheduler spills the coldest victim stream to host instead of
  discarding its KV. Tier size and water marks are autopilot knobs
  (``serve.tier_host_pages`` / ``serve.tier_low_water_pct``).
* :class:`FleetPrefixMap` — a bounded fleet map of prefix digest →
  replicas holding it resident, fed from the SSTATS ``prefix_residency``
  snapshots the router already polls. The router adds an affinity bonus to
  ``projected_ttft_ms`` so identical prefixes stop prefilling N times
  across N replicas (``fleet.affinity_weight``; brownout zeroes it under
  overload).

Telemetry rides under ``tier.*``.
"""

from maggy_tpu_torch.serve.tier.host_pool import HostPagePool
from maggy_tpu_torch.serve.tier.prefixmap import FleetPrefixMap
from maggy_tpu_torch.serve.tier.tiering import TieringPolicy

__all__ = ["HostPagePool", "TieringPolicy", "FleetPrefixMap"]
