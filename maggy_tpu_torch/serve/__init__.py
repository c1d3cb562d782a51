"""Continuous-batching serving: the engine and the host-side pieces it uses.

Counterpart of :mod:`maggy_tpu.serve` as far as its :class:`Engine`: a
fixed-slot KV-cache engine whose one decode program serves a churning
request population (prefill into free slots, eviction on EOS/``max_new``),
with paged KV, prefix reuse and asynchronous decode, over port-owned copies
of the slot manager, prefix index, block allocator, page table, request and
QoS modules. The scheduler, the RPC server and client, the host-DRAM tier
and the fleet follow in later slices (ROADMAP queue 1 item 6).

    from maggy_tpu_torch.serve import Engine, Request, SamplingParams
    engine = Engine(cfg, model, num_slots=8)          # model: a trained Decoder
    slot, first = engine.admit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new=16)))
    tokens = engine.step().tokens                      # {slot: token}
"""

from maggy_tpu_torch.serve.engine import Engine
from maggy_tpu_torch.serve.paging import BlockAllocator, OutOfPagesError, PageTable
from maggy_tpu_torch.serve.prefix import PrefixIndex
from maggy_tpu_torch.serve.request import Request, SamplingParams
from maggy_tpu_torch.serve.slots import SlotManager

__all__ = [
    "BlockAllocator",
    "Engine",
    "OutOfPagesError",
    "PageTable",
    "PrefixIndex",
    "Request",
    "SamplingParams",
    "SlotManager",
]
