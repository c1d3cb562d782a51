"""Parallelism specification: the axis names, ``ShardingSpec`` and
``SliceTopology``.

Own copy of :mod:`maggy_tpu.parallel.spec` (the port imports nothing of the
JAX package). A spec declares the mesh the JAX package lays out over six
axes (pipeline stage, data, fsdp, expert, sequence, tensor); the port runs
``dp``, ``fsdp``, ``sp``, ``tp`` and ``pp`` on a ``torch.distributed``
``DeviceMesh`` (one rank per card), ``sp`` through ring or Ulysses
attention over the ``seq`` axis, ``pp`` as the pipeline schedules of
:mod:`maggy_tpu_torch.parallel.pipeline` over the ``stage`` axis, and
``zero_stage``/``bucket_mb`` as the bucketed and ZeRO-1 steps of
:mod:`maggy_tpu_torch.parallel.overlap`. What it does not run yet raises
``NotImplementedError`` at construction, naming its ROADMAP queue 1 item:
``ep`` (item 8). As in JAX, ``pp`` with ``sp`` is refused by the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

AXIS_STAGE = "stage"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
# outermost data axis of a multi-slice mesh (elastic membership, ROADMAP item 7f2)
AXIS_SLICE = "slice"

# the JAX package's mesh axes, in its layout-priority order (outer to inner)
MESH_AXES = (AXIS_STAGE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR)
SLICE_MESH_AXES = (AXIS_SLICE,) + MESH_AXES

# ShardingSpec fields that are mesh-axis extents (the rest are tuning knobs)
_AXIS_FIELDS = ("dp", "fsdp", "tp", "sp", "ep", "pp")


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is ROADMAP queue 1 item {item}, not ported yet")


@dataclasses.dataclass(frozen=True, init=False)
class ShardingSpec:
    """Logical parallelism degrees; 1 disables an axis.

    ``dp``    data parallelism: the batch over ``data``, parameters
              replicated (FSDP2's HSDP replicate dimension);
    ``fsdp``  parameters, gradients and optimizer state sharded over
              ``fsdp`` (FSDP2 ``fully_shard``), the batch over it too;
    ``tp``    tensor parallelism over ``tensor`` (DTensor
              ``parallelize_module``): attention heads, the MLP hidden
              width and the vocabulary;
    ``sp``    sequence parallelism over ``seq``: ring or Ulysses
              attention, alone or with any of the axes above;
    ``pp``    pipeline parallelism over ``stage``: each rank runs one
              stage of the Decoder's layers (GPipe and 1F1B), with
              ``dp``, ``fsdp`` (both data parallel here: stage parameters
              are replicated over them, as in JAX) and ``tp``;
    ``zero_stage`` 0 or 1: ZeRO-1 shards the optimizer state over
              ``data`` (a pure ``dp`` mesh; elsewhere it stays off, with
              a warning, as in JAX);
    ``bucket_mb`` the gradient-reduction bucket in MiB (None: unbucketed);
    ``ep``: the JAX spec's field, accepted only at 1.
    """

    dp: int
    fsdp: int
    tp: int
    sp: int
    ep: int
    pp: int
    zero_stage: int
    bucket_mb: Optional[float]

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1,
                 zero_stage: int = 0, bucket_mb: Optional[float] = None, **unknown):
        if unknown:
            raise TypeError(f"ShardingSpec got unknown fields {sorted(unknown)}")
        values = dict(dp=dp, fsdp=fsdp, tp=tp, sp=sp, ep=ep, pp=pp, zero_stage=zero_stage, bucket_mb=bucket_mb)
        for name in _AXIS_FIELDS:
            v = values[name]
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"ShardingSpec.{name} must be a positive int, got {v!r}")
        if zero_stage not in (0, 1):
            raise ValueError(f"ShardingSpec.zero_stage must be 0 or 1, got {zero_stage!r}")
        if bucket_mb is not None and not float(bucket_mb) > 0:
            raise ValueError(f"ShardingSpec.bucket_mb must be positive (or None), got {bucket_mb!r}")
        if ep > 1:
            _refuse(f"expert parallelism (ep={ep}, with moe.py)", "8")
        for name, v in values.items():
            object.__setattr__(self, name, v)

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def axis_sizes(self) -> Tuple[int, ...]:
        """Extent per :data:`MESH_AXES` entry."""
        return (self.pp, self.dp, self.fsdp, self.ep, self.sp, self.tp)

    @classmethod
    def preset(cls, name: str, num_devices: int) -> "ShardingSpec":
        """The JAX package's presets: "dp"/"ddp" pure data parallel,
        "fsdp"/"zero"/"zero3" full sharding, "tp" tensor parallel, "2d"
        fsdp x tp, "sp" sequence parallel, "pp" pipeline stages; "ep"
        raises, naming its item."""
        n = num_devices
        if name in ("dp", "ddp"):
            return cls(dp=n)
        if name in ("fsdp", "zero", "zero3"):
            return cls(fsdp=n)
        if name == "tp":
            return cls(tp=n)
        if name == "sp":
            return cls(sp=n)
        if name == "pp":
            return cls(pp=n)
        if name == "2d":
            tp = _largest_factor_leq(n, max(1, int(n**0.5)))
            return cls(fsdp=n // tp, tp=tp)
        if name == "ep":
            ep = _largest_factor_leq(n, max(1, int(n**0.5)))
            return cls(ep=ep, fsdp=n // ep)
        raise ValueError(f"Unknown sharding preset {name!r}")

    def scaled_to(self, num_devices: int) -> "ShardingSpec":
        """Grow or shrink the dp axis so the spec covers exactly ``num_devices``."""
        rest = self.fsdp * self.tp * self.sp * self.ep * self.pp
        if num_devices % rest != 0:
            raise ValueError(f"{num_devices} devices not divisible by non-dp axes product {rest}")
        return dataclasses.replace(self, dp=num_devices // rest)


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A multi-slice layout: ``n_slices`` slices, each running
    ``slice_spec``, under an outer :data:`AXIS_SLICE` data axis. A value
    class here: the sliced mesh it describes (the elastic reshape) is
    ROADMAP queue 1 item 7f2."""

    n_slices: int = 1
    slice_spec: ShardingSpec = dataclasses.field(default_factory=ShardingSpec)

    def __post_init__(self):
        if not isinstance(self.n_slices, int) or self.n_slices < 1:
            raise ValueError(f"SliceTopology.n_slices must be a positive int, got {self.n_slices!r}")

    @property
    def num_devices(self) -> int:
        return self.n_slices * self.slice_spec.num_devices

    @property
    def devices_per_slice(self) -> int:
        return self.slice_spec.num_devices

    def axis_sizes(self) -> Tuple[int, ...]:
        """Extent per :data:`SLICE_MESH_AXES` entry (slice outermost)."""
        return (self.n_slices,) + self.slice_spec.axis_sizes()

    def with_slices(self, n_slices: int) -> "SliceTopology":
        """The same per-slice layout at another width."""
        return dataclasses.replace(self, n_slices=n_slices)


def _largest_factor_leq(n: int, cap: int) -> int:
    for f in range(min(cap, n), 0, -1):
        if n % f == 0:
            return f
    return 1
