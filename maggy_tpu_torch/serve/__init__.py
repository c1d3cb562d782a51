"""Continuous-batching serving: the engine, its scheduler and the RPC stack.

Counterpart of :mod:`maggy_tpu.serve` on one device: a fixed-slot KV-cache
engine whose one decode program serves a churning request population
(prefill into free slots, eviction on EOS/``max_new``), with paged KV,
prefix reuse, asynchronous decode, the host-DRAM KV tier and the
disaggregated-prefill handoff; the QoS-aware :class:`Scheduler` (admission
by class, quotas, priority preemption); and the RPC front-end
(:class:`ServeServer`), :class:`ServeClient`, the traffic replay of
:mod:`~maggy_tpu_torch.serve.loadgen` and the CLI. The fleet (router,
replicas, disaggregated prefill, autoscaler) is
:mod:`maggy_tpu_torch.serve.fleet`.

    # server:  python -m maggy_tpu_torch.serve --config llama3_8b --slots 8
    # client:
    from maggy_tpu_torch.serve import ServeClient
    client = ServeClient((host, port), secret)
    tokens = client.generate([1, 2, 3], max_new=16)

In-process use (no sockets): build ``Engine`` + ``Scheduler`` directly.
"""

from maggy_tpu_torch.serve.client import ServeClient  # noqa: F401
from maggy_tpu_torch.serve.engine import Engine  # noqa: F401
from maggy_tpu_torch.serve.loadgen import (  # noqa: F401
    Arrival,
    Burst,
    TenantMix,
    TrafficReplay,
    TrafficSpec,
)
from maggy_tpu_torch.serve.paging import (  # noqa: F401
    BlockAllocator,
    OutOfPagesError,
    PageTable,
)
from maggy_tpu_torch.serve.prefix import PrefixIndex  # noqa: F401
from maggy_tpu_torch.serve.qos import (  # noqa: F401
    BEST_EFFORT,
    PREMIUM,
    QOS_CLASSES,
    STANDARD,
    QosQueue,
    QuotaLedger,
)
from maggy_tpu_torch.serve.request import Request, SamplingParams  # noqa: F401
from maggy_tpu_torch.serve.scheduler import Scheduler  # noqa: F401
from maggy_tpu_torch.serve.server import ServeServer  # noqa: F401
from maggy_tpu_torch.serve.slots import SlotManager  # noqa: F401

__all__ = [
    "Arrival",
    "BEST_EFFORT",
    "BlockAllocator",
    "Burst",
    "Engine",
    "OutOfPagesError",
    "PREMIUM",
    "PageTable",
    "PrefixIndex",
    "QOS_CLASSES",
    "QosQueue",
    "QuotaLedger",
    "STANDARD",
    "Scheduler",
    "ServeServer",
    "ServeClient",
    "SlotManager",
    "Request",
    "SamplingParams",
    "TenantMix",
    "TrafficReplay",
    "TrafficSpec",
]
