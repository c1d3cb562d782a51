"""Parallelism: the sharding spec, the device mesh and its placement rules,
and sequence-parallel ring attention.

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
    "mesh_for",
    "ring_attention",
    "shard_decoder",
]
