"""Parallelism specification: the axis names and ``ShardingSpec``.

Own copy of what the port needs of :mod:`maggy_tpu.parallel.spec` (the port
imports nothing of the JAX package). The JAX spec declares six axes
(pipeline stage, data, fsdp, expert, sequence, tensor) and the gradient
overlap knobs; the port runs sequence parallelism (``sp``, the ring) alone
so far. Naming any other axis or knob with a value that turns it on raises
``NotImplementedError`` at construction (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses

AXIS_SEQ = "seq"
# the JAX package's mesh axes, in its layout-priority order
MESH_AXES = ("stage", "data", "fsdp", "expert", AXIS_SEQ, "tensor")

# the JAX spec's other fields, each with the value that leaves it off
_NOT_PORTED = {"dp": 1, "fsdp": 1, "tp": 1, "ep": 1, "pp": 1, "zero_stage": 0, "bucket_mb": None}


def _refuse(what) -> None:
    raise NotImplementedError(
        f"the port runs sequence parallelism only; {what} is ROADMAP queue 1 "
        "item 7 (multi-device training), not ported yet"
    )


@dataclasses.dataclass(frozen=True, init=False)
class ShardingSpec:
    """The sequence-parallel degree ``sp`` (ring attention over ``sp``
    ranks); 1 disables it. The JAX spec's other fields may be named only
    with the value that leaves them off."""

    sp: int

    def __init__(self, sp: int = 1, **others):
        unknown = sorted(set(others) - set(_NOT_PORTED))
        if unknown:
            raise TypeError(f"ShardingSpec got unknown fields {unknown}")
        on = {k: v for k, v in others.items() if v != _NOT_PORTED[k]}
        if on:
            _refuse(on)
        if not isinstance(sp, int) or sp < 1:
            raise ValueError(f"ShardingSpec.sp must be a positive int, got {sp!r}")
        object.__setattr__(self, "sp", sp)

    @property
    def num_devices(self) -> int:
        return self.sp

    @classmethod
    def preset(cls, name: str, num_devices: int) -> "ShardingSpec":
        """The "sp" preset: every device on the sequence axis. The JAX
        package's other presets raise."""
        if name == "sp":
            return cls(sp=num_devices)
        if name in ("dp", "ddp", "fsdp", "zero", "zero3", "tp", "pp", "2d", "ep"):
            _refuse(f"the {name!r} preset")
        raise ValueError(f"Unknown sharding preset {name!r}")
