"""Parallelism: the sharding spec and sequence-parallel ring attention.

Importing this package starts no process group and loads no CUDA library.
"""

from maggy_tpu_torch.parallel.ringattention import (
    LocalRing,
    ProcessGroupRing,
    make_ring_attention,
    ring_attention,
)
from maggy_tpu_torch.parallel.spec import AXIS_SEQ, MESH_AXES, ShardingSpec

__all__ = [
    "AXIS_SEQ",
    "LocalRing",
    "MESH_AXES",
    "ProcessGroupRing",
    "ShardingSpec",
    "make_ring_attention",
    "ring_attention",
]
