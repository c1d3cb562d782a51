"""Device-mesh construction: the port's copy of :mod:`maggy_tpu.parallel.mesh`.

A ``torch.distributed.device_mesh.DeviceMesh`` over the six axes of
:class:`~maggy_tpu_torch.parallel.spec.ShardingSpec`, named as the JAX
package names them and laid out in its order (``stage`` outermost,
``tensor`` innermost). Each rank of the mesh is one process holding one
device, so the mesh is built over an initialised default process group:
NCCL with one card per rank, or gloo on the CPU. Axes of extent 1 stay in
the mesh, as in JAX, so ``mesh["fsdp"]`` always names a dimension.

A sliced mesh (:func:`make_slice_mesh`) puts the ``slice`` axis
outermost, above the six: a slice is a contiguous block of rank processes
(:func:`slice_device_groups`), the batch is split over (``slice``,
``data``, ``fsdp``) and no parameter over ``slice``. An elastic reshape
leaves the default group (:func:`leave_group`) and builds a new mesh over
the ranks of the slices still active.

Every axis has a process group of its own (``mesh.get_group(axis)``;
:func:`seq_group`, :func:`expert_group`, :func:`stage_group`): ring and
Ulysses attention run over ``seq``, the MoE expert exchange over
``expert``, the bucketed and ZeRO-1 reductions over ``data`` (then
``slice``), the pipeline's hand-offs between the previous and the next
stage (:func:`stage_neighbors`) over ``stage``.

Host-side agreement (:func:`any_rank`, :func:`from_rank0`) runs over a gloo
twin of the default group (:func:`host_group`), so a flag or a step number
crosses the ranks without waiting for the card.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

import torch

from maggy_tpu_torch.parallel.spec import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_SLICE,
    AXIS_STAGE,
    MESH_AXES,
    SLICE_MESH_AXES,
    ShardingSpec,
    SliceTopology,
)

_ambient = threading.local()
# how long a rank waits for its peers at each collective before NCCL or gloo
# gives up
PROCESS_GROUP_TIMEOUT_S = 600.0
# (the default process group, its gloo twin)
_host: tuple = (None, None)


def _world_for_mesh(device_type: str) -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans one process per device: initialise torch.distributed "
            "(init_process_group) before make_mesh"
        )
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh lies on cuda or cpu devices, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' for a mesh of CPU ranks")
    return dist.get_world_size()


def make_mesh(spec: ShardingSpec, device_type: str = "cuda"):
    """A DeviceMesh for ``spec`` over the default process group, whose size
    must equal ``spec.num_devices``. ``device_type`` is ``"cuda"`` (each rank
    on its current card) unless the caller asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_for_mesh(device_type)
    if spec.num_devices != world:
        raise ValueError(
            f"ShardingSpec covers {spec.num_devices} devices but the process group has "
            f"{world} ranks; use spec.scaled_to({world})."
        )
    return init_device_mesh(device_type, spec.axis_sizes(), mesh_dim_names=MESH_AXES)


def make_slice_mesh(topology: SliceTopology, device_type: str = "cuda"):
    """A DeviceMesh with the outer ``slice`` axis for ``topology`` over the
    default process group, whose ranks are the active slices' ranks in
    slice order (slice 0's block, then slice 1's, ...), as
    :func:`slice_device_groups` cuts them. An elastic reshape calls it again
    over the group re-formed from the surviving slices' ranks, with
    ``topology.with_slices(len(survivors))``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_for_mesh(device_type)
    if topology.num_devices != world:
        raise ValueError(
            f"SliceTopology covers {topology.num_devices} devices "
            f"({topology.n_slices} slice(s) x {topology.devices_per_slice}) "
            f"but the process group has {world} ranks"
        )
    return init_device_mesh(device_type, topology.axis_sizes(), mesh_dim_names=SLICE_MESH_AXES)


def slice_device_groups(n_slices: int, ranks: Sequence) -> List[list]:
    """``ranks`` (rank processes, or anything listed in slice-major order)
    cut into ``n_slices`` contiguous slices of equal size. A count that does
    not split evenly raises: ragged slices would give the slices different
    layouts across a reshape."""
    ranks = list(ranks)
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if len(ranks) % n_slices != 0:
        raise ValueError(
            f"{len(ranks)} ranks do not split into {n_slices} equal "
            "slices; adjust num_slices or the rank count"
        )
    per = len(ranks) // n_slices
    return [ranks[i * per:(i + 1) * per] for i in range(n_slices)]


def mesh_for(num_devices: Optional[int] = None, sharding: Union[str, ShardingSpec] = "fsdp",
             device_type: str = "cuda"):
    """Resolve a preset or spec against the process group's ranks (a spec of
    another size is scaled along dp) and build its mesh: ``(mesh, spec)``."""
    import torch.distributed as dist

    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if isinstance(sharding, ShardingSpec):
        spec = sharding if sharding.num_devices == num_devices else sharding.scaled_to(num_devices)
    else:
        spec = ShardingSpec.preset(sharding, num_devices)
    return make_mesh(spec, device_type), spec


def ambient_mesh():
    """The mesh a :class:`~maggy_tpu_torch.train.TrainContext` made current
    in this thread (None outside one)."""
    return getattr(_ambient, "mesh", None)


def set_ambient_mesh(mesh) -> None:
    _ambient.mesh = mesh


def mesh_shape(mesh) -> dict:
    """``{axis name: extent}`` of a DeviceMesh, in its order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def replica_mesh(mesh):
    """The one-dimensional mesh of the ranks that hold the same parameters
    and different rows: ``data``, or on a sliced mesh (``slice``,
    ``data``) flattened into one dimension (``slice`` outer) when both are
    above 1; None when neither is."""
    shape = mesh_shape(mesh)
    axes = [a for a in (AXIS_SLICE, AXIS_DATA) if shape.get(a, 1) > 1]
    if not axes:
        return None
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[tuple(axes)]._flatten("replica")


def seq_group(mesh):
    """The process group of this rank's ranks along ``seq``: those holding
    the other chunks of its sequence, in chunk order."""
    return mesh.get_group(AXIS_SEQ)


def expert_group(mesh):
    """The process group of this rank's ranks along ``expert``: one rank per
    share of the experts, in expert order, routing the same tokens."""
    return mesh.get_group(AXIS_EXPERT)


def stage_group(mesh):
    """The process group of this rank's ranks along ``stage``: one rank per
    pipeline stage, in stage order, the others at this rank's coordinates
    on every other axis."""
    return mesh.get_group(AXIS_STAGE)


def stage_neighbors(mesh):
    """``(previous, next)``: the global ranks of the stages before and after
    this rank's along ``stage`` (None past either end)."""
    import torch.distributed as dist

    group = stage_group(mesh)
    s, n = mesh.get_local_rank(AXIS_STAGE), mesh.size(mesh.mesh_dim_names.index(AXIS_STAGE))
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n - 1 else None
    return prev, nxt


def host_group():
    """A gloo group over every rank of the default process group (the
    default group itself when it is gloo), made at its first use, once per
    default group: that first use is a collective, reached by every rank."""
    import datetime

    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    global _host
    default = distributed_c10d._get_default_group()
    if _host[0] is not default:
        twin = default if dist.get_backend(default) == "gloo" else dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
        _host = (default, twin)
    return _host[1]


def leave_group() -> None:
    """Leave the default process group and every group made from it (the
    mesh's, the gloo twin), at a step boundary where no collective is in
    flight, so that the rank can join a group of another size; the ambient
    mesh goes with them."""
    import torch.distributed as dist

    global _host
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host = (None, None)
    set_ambient_mesh(None)


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is true on any rank; every rank must call it."""
    import torch.distributed as dist

    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def from_rank0(value):
    """Rank 0's ``value`` (any picklable object) on every rank; every rank
    must call it, and what the others pass is ignored."""
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]
