"""Parallelism: the sharding spec, the device mesh and its placement rules,
sequence parallelism (ring and Ulysses attention), and the bucketed and
ZeRO-1 gradient reduction (:mod:`~maggy_tpu_torch.parallel.overlap`).

Importing this package starts no process group and loads no CUDA library.
"""

from maggy_tpu_torch.parallel.mesh import ambient_mesh, make_mesh, mesh_for
from maggy_tpu_torch.parallel.ringattention import (
    LocalRing,
    ProcessGroupRing,
    make_ring_attention,
    ring_attention,
)
from maggy_tpu_torch.parallel.sharding import DEFAULT_RULES, PORT_RULES, logical_to_mesh_axes, shard_decoder
from maggy_tpu_torch.parallel.spec import AXIS_SEQ, MESH_AXES, ShardingSpec, SliceTopology
from maggy_tpu_torch.parallel.ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "AXIS_SEQ",
    "DEFAULT_RULES",
    "LocalRing",
    "MESH_AXES",
    "PORT_RULES",
    "ProcessGroupRing",
    "ShardingSpec",
    "SliceTopology",
    "ambient_mesh",
    "logical_to_mesh_axes",
    "make_mesh",
    "make_ring_attention",
    "make_ulysses_attention",
    "mesh_for",
    "ring_attention",
    "shard_decoder",
    "ulysses_attention",
]
