"""Expert parallelism over the mesh's ``expert`` axis.

JAX lays an ``MoEDecoder`` out by its rules alone: the expert weights
(``w_gate``/``w_up``/``w_down``, ``[experts, ...]``) are sharded over
``expert`` (the ``("expert", "expert")`` rule), the batch over (``data``,
``fsdp``) and NOT over ``expert``, and GSPMD inserts the collectives. The
port places the same layout by hand:

* every rank of an ``expert`` group routes the same tokens: the router,
  the dispatch and combine one-hots and the auxiliary loss are computed
  replicated, so the non-expert parameters get the same gradient on every
  expert rank and no gradient is ever summed over ``expert``;
* each rank holds ``n_experts / ep`` experts (:func:`expert_parallelize`
  keeps this rank's slice of the full weights). Before the expert FFNs
  :func:`take_experts` cuts this rank's experts out of the dispatched
  tokens (backward: the gradient all-gathered over ``expert``); after them
  :func:`gather_experts` all-gathers every expert's output (backward: this
  rank's slice of the gradient);
* the router's load-balancing statistics are means over the GLOBAL batch,
  as in JAX's GSPMD step: :func:`batch_mean` all-reduces a rank's means
  over the batch ranks (``slice``, ``data``, ``fsdp``). Its backward passes
  the gradient to the local term scaled by ``1 / n_batch`` and reduces
  nothing: each rank differentiates its own tokens' share, and the
  gradients are summed over the batch ranks with every other gradient.

The routing groups of ``group_size`` tokens are cut from the flattened
global ``B * S`` in JAX; a rank's rows give the same groups only when they
hold whole groups, so a shape where they do not raises (:class:`ExpertPlacement`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import torch

# the attribute that marks a parameter sharded over ``expert`` (its extent),
# set on the parameters FSDP2 leaves in the module
EXPERT_ATTR = "_maggy_expert_extent"
# the expert weights of an MoE block, laid out [experts, ...]
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class ExpertPlacement:
    """How one MoE block sits on the mesh: ``ep`` ranks along ``expert``
    (``rank`` this one, ``group`` their process group, None at 1), and the
    process groups of the batch axes of extent above 1 (``batch_groups``,
    ``n_batch`` ranks in all) its router statistics are averaged over."""

    ep: int = 1
    rank: int = 0
    group: Any = None
    batch_groups: Tuple[Any, ...] = ()
    n_batch: int = 1

    def group_size(self, cfg, local_tokens: int) -> int:
        """The routing group of a rank holding ``local_tokens`` tokens:
        JAX's ``min(group_size, global tokens)``, checked to cut this
        rank's tokens into whole groups."""
        g = min(cfg.group_size, local_tokens * self.n_batch)
        if self.n_batch > 1 and local_tokens % g:
            raise ValueError(
                f"{local_tokens} tokens a batch rank do not hold whole routing groups of {g} (group_size="
                f"{cfg.group_size}, {self.n_batch} batch ranks): JAX cuts its groups from the global "
                "batch, so the ranks' routing would differ from it; make each rank's rows x seq a "
                "multiple of group_size"
            )
        return g


class _TakeExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        n = x.shape[0] // place.ep
        return x[place.rank * n:(place.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.place), None


class _GatherExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return _all_gather(x, place)

    @staticmethod
    def backward(ctx, grad):
        place = ctx.place
        n = grad.shape[0] // place.ep
        return grad[place.rank * n:(place.rank + 1) * n].contiguous(), None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, place):
        import torch.distributed as dist

        ctx.n = place.n_batch
        out = x.detach().clone()
        for group in place.batch_groups:
            dist.all_reduce(out, group=group)
        return out / place.n_batch

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def _all_gather(x: torch.Tensor, place: ExpertPlacement) -> torch.Tensor:
    """``x`` of every rank of the ``expert`` group, concatenated on dim 0
    in rank order."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel.overlap import all_gather_flat

    x = x.contiguous()
    out = x.new_empty((x.shape[0] * place.ep,) + tuple(x.shape[1:]))
    all_gather_flat(dist)(out, x, group=place.group)
    return out


def take_experts(x: torch.Tensor, place) -> torch.Tensor:
    """This rank's experts' rows of ``x`` ``[experts, ...]`` (replicated
    over ``expert``); the whole of ``x`` without expert parallelism."""
    return x if place is None or place.ep == 1 else _TakeExperts.apply(x, place)


def gather_experts(x: torch.Tensor, place) -> torch.Tensor:
    """Every expert's rows from this rank's ``x`` ``[experts / ep, ...]``."""
    return x if place is None or place.ep == 1 else _GatherExperts.apply(x, place)


def batch_mean(x: torch.Tensor, place) -> torch.Tensor:
    """The mean of every batch rank's ``x`` (a rank's mean over its own
    tokens, so the result is the global batch's), differentiable into this
    rank's term; ``x`` itself on one batch rank."""
    return x if place is None or place.n_batch == 1 else _BatchMean.apply(x, place)


def moe_blocks(model) -> Iterator[Tuple[str, Any]]:
    """``(name, module)`` of every MoE block of ``model``."""
    from maggy_tpu_torch.models.moe import MoEBlock

    return ((name, mod) for name, mod in model.named_modules() if isinstance(mod, MoEBlock))


def is_moe(model) -> bool:
    return next(moe_blocks(model), None) is not None


def expert_parallelize(model, mesh) -> None:
    """Place ``model``'s MoE blocks on ``mesh`` in place: each keeps this
    rank's ``n_experts / ep`` experts of the full weights it holds (the
    same on every rank) and learns its :class:`ExpertPlacement`. Call it
    before FSDP2 wraps the model."""
    from torch import nn

    from maggy_tpu_torch.parallel.mesh import expert_group, mesh_shape
    from maggy_tpu_torch.parallel.sharding import batch_group_axes
    from maggy_tpu_torch.parallel.spec import AXIS_EXPERT

    shape = mesh_shape(mesh)
    ep = shape.get(AXIS_EXPERT, 1)
    axes = batch_group_axes(shape)
    place = ExpertPlacement(
        ep=ep,
        rank=mesh.get_local_rank(AXIS_EXPERT) if ep > 1 else 0,
        group=expert_group(mesh) if ep > 1 else None,
        batch_groups=tuple(mesh.get_group(a) for a in axes),
        n_batch=math.prod(shape[a] for a in axes),
    )
    for _, block in moe_blocks(model):
        e = block.cfg.n_experts
        if e % ep:
            raise ValueError(
                f"n_experts={e} not divisible by ep={ep}: the expert axis would silently replicate "
                "instead of sharding the expert FFNs"
            )
        n = e // ep
        for w in EXPERT_WEIGHTS:
            full = getattr(block, w)
            local = full.detach()[place.rank * n:(place.rank + 1) * n].clone()
            setattr(block, w, nn.Parameter(local, requires_grad=full.requires_grad))
        block.placement = place


def tag_expert_params(model) -> None:
    """Mark the expert weights (as FSDP2 left them) with the ``expert``
    extent they are sharded over, for :func:`expert_extent` and
    :func:`~maggy_tpu_torch.parallel.sharding.placed_mesh_axes`."""
    for _, block in moe_blocks(model):
        ep = block.placement.ep if block.placement is not None else 1
        for w in EXPERT_WEIGHTS:
            setattr(getattr(block, w), EXPERT_ATTR, ep)


def expert_extent(param) -> int:
    """The ``expert`` extent ``param`` is sharded over (1: not)."""
    return getattr(param, EXPERT_ATTR, 1)


def expert_params(model) -> Dict[str, Tuple[torch.Tensor, ExpertPlacement]]:
    """``{name: (parameter, placement)}`` of the expert weights sharded
    over an ``expert`` axis above 1."""
    out = {}
    for name, block in moe_blocks(model):
        place = block.placement
        if place is None or place.ep == 1:
            continue
        for w in EXPERT_WEIGHTS:
            out[f"{name}.{w}" if name else w] = (getattr(block, w), place)
    return out


def gather_expert_tensor(t: torch.Tensor, place: ExpertPlacement) -> torch.Tensor:
    """The whole ``[experts, ...]`` tensor from this rank's share ``t`` (a
    plain tensor, or FSDP2's DTensor shard of this rank's experts): the
    shard gathered over its own mesh first, then every rank's experts over
    ``expert``. A collective of both groups."""
    local = t.full_tensor() if hasattr(t, "full_tensor") else t
    return _all_gather(local.detach(), place)


@torch.no_grad()
def scatter_expert_tensor(dst: torch.Tensor, full: torch.Tensor, place: ExpertPlacement) -> None:
    """Copy this rank's share of the whole ``[experts, ...]`` tensor
    ``full`` into ``dst`` (a plain tensor of this rank's experts, or
    FSDP2's DTensor shard of them). Local: every rank holds ``full``."""
    n = full.shape[0] // place.ep
    mine = full[place.rank * n:(place.rank + 1) * n].to(dst.dtype)
    if hasattr(dst, "to_local"):
        from torch.distributed.tensor import distribute_tensor

        mine = distribute_tensor(mine.to(dst.to_local().device), dst.device_mesh, dst.placements,
                                 src_data_rank=None).to_local()
        dst = dst.to_local()
    dst.copy_(mine.reshape(dst.shape))
