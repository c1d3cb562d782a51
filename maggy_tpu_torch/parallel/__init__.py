"""Parallelism: the sharding spec, the device mesh (sliced too) and its placement rules,
sequence parallelism (ring and Ulysses attention), and the bucketed and
ZeRO-1 gradient reduction (:mod:`~maggy_tpu_torch.parallel.overlap`).

Importing this package starts no process group and loads no CUDA library.
"""

from maggy_tpu_torch.parallel.mesh import ambient_mesh, make_mesh, make_slice_mesh, mesh_for, slice_device_groups
from maggy_tpu_torch.parallel.ringattention import (
    LocalRing,
    ProcessGroupRing,
    make_ring_attention,
    ring_attention,
)
from maggy_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    PORT_RULES,
    logical_to_mesh_axes,
    shard_decoder,
    slice_rules,
)
from maggy_tpu_torch.parallel.spec import AXIS_SEQ, AXIS_SLICE, MESH_AXES, SLICE_MESH_AXES, ShardingSpec, SliceTopology
from maggy_tpu_torch.parallel.ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "AXIS_SEQ",
    "AXIS_SLICE",
    "DEFAULT_RULES",
    "LocalRing",
    "MESH_AXES",
    "PORT_RULES",
    "ProcessGroupRing",
    "SLICE_MESH_AXES",
    "ShardingSpec",
    "SliceTopology",
    "ambient_mesh",
    "logical_to_mesh_axes",
    "make_mesh",
    "make_slice_mesh",
    "make_ring_attention",
    "make_ulysses_attention",
    "mesh_for",
    "ring_attention",
    "shard_decoder",
    "slice_device_groups",
    "slice_rules",
    "ulysses_attention",
]
