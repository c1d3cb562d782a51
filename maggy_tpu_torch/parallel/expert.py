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

Under ``tensor`` (JAX's ``mlp -> tensor`` rule on the expert weights'
``("expert", "embed", "mlp")`` / ``("expert", "mlp", "embed")`` axes) each
rank also keeps its ``d_ff / tp`` columns of ``w_gate``/``w_up`` and rows of
``w_down``, and Megatron's pair runs around the expert FFNs, over the
``tensor`` group, inside the expert exchange: :func:`take_experts`, then
:func:`tensor_in` (identity; backward: the gradient all-reduced), the FFNs
on ``[e / ep, ., d_ff / tp]``, :func:`tensor_out` (the partial sums
all-reduced; backward: identity), then :func:`gather_experts`. ``expert_out``
is whole before the combine einsum, so the gate's and with it the router's
gradient come out the same on every tensor rank with no further sum; the
router, the one-hots and the aux term stay replicated over ``tensor`` as
they are over ``expert``. Every tensor rank routes the same bits: the
router's input is the residual stream after the attention's row-parallel
all-reduce, and nothing is recomputed rank-locally before it.

One mesh for the optimizer: under ``tensor`` the expert weights are DTensors
on the tensor mesh (``Shard`` over their ``mlp`` dim, each holding this
rank's experts) and the router a DTensor replicated over it, as the norm
scales are (:func:`~maggy_tpu_torch.parallel.sharding.tensor_parallelize`
places both), so a foreach AdamW sees one list of DTensors on one mesh; the
forward reads each weight's local shard (``to_local``, whose backward hands
the gradient back as the same DTensor). A separate optimizer group for
plain tensors would have left the choice to every caller's optimizer.

Under pp (a ``stage`` axis above 1) the stage body sees this rank's
microbatch rows alone: JAX's pipeline is manual over ``data`` and
``fsdp``, so its router statistics are a rank's own microbatch's, averaged
over the ranks with the loss. The placement then has no batch group and
:func:`batch_mean` reduces nothing.

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
    (``rank`` this one, ``group`` their process group, None at 1), ``tp``
    ranks along ``tensor`` (``tensor_group``) splitting the
    FFNs' hidden width, and the process groups of the batch axes of extent
    above 1 (``batch_groups``, ``n_batch`` ranks in all) its router
    statistics are averaged over."""

    ep: int = 1
    rank: int = 0
    group: Any = None
    batch_groups: Tuple[Any, ...] = ()
    n_batch: int = 1
    tp: int = 1
    tensor_group: Any = None

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


class _TensorIn(torch.autograd.Function):
    """Megatron's f: identity; backward, the gradient summed over ``tensor``
    (each rank differentiated its own hidden columns)."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.place.tensor_group)
        return grad, None


class _TensorOut(torch.autograd.Function):
    """Megatron's g: the partial products summed over ``tensor``; backward,
    identity (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, place):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=place.tensor_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


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


def tensor_in(x: torch.Tensor, place) -> torch.Tensor:
    """The expert FFNs' input, replicated over ``tensor``: ``x`` itself;
    its gradient is summed over the tensor ranks."""
    return x if place is None or place.tp == 1 else _TensorIn.apply(x, place)


def tensor_out(x: torch.Tensor, place) -> torch.Tensor:
    """The expert FFNs' output from this rank's hidden columns, summed over
    ``tensor``: whole on every tensor rank."""
    return x if place is None or place.tp == 1 else _TensorOut.apply(x, place)


def local_weight(w: torch.Tensor) -> torch.Tensor:
    """The shard of ``w`` this rank computes with: a DTensor's local tensor
    (differentiable), or ``w``."""
    return w.to_local() if hasattr(w, "to_local") else w


def batch_mean(x: torch.Tensor, place) -> torch.Tensor:
    """The mean of every batch rank's ``x`` (a rank's mean over its own
    tokens, so the result is the global batch's), differentiable into this
    rank's term; ``x`` itself on one batch rank."""
    return x if place is None or place.n_batch == 1 else _BatchMean.apply(x, place)


def moe_blocks(model) -> Iterator[Tuple[str, Any]]:
    """``(name, module)`` of every MoE block of ``model``."""
    from maggy_tpu_torch.models.moe import MoEBlock

    return ((name, mod) for name, mod in model.named_modules() if isinstance(mod, MoEBlock))


def is_moe(obj) -> bool:
    """Whether ``obj`` (a model, a pipeline stage or a config) is an MoE one."""
    from maggy_tpu_torch.models.moe import MoEConfig

    return isinstance(getattr(obj, "cfg", obj), MoEConfig)


def expert_parallelize(model, mesh) -> None:
    """Place ``model``'s MoE blocks (a model's, or a pipeline stage's) on
    ``mesh`` in place: each keeps this rank's ``n_experts / ep`` experts of
    the weights it holds (the same on every rank; under ``tensor`` the
    DTensor shards :func:`~maggy_tpu_torch.parallel.sharding.tensor_parallelize`
    left, whose layout it keeps) and learns its :class:`ExpertPlacement`.
    Its router statistics are averaged over the batch ranks, but under pp
    (JAX's are each rank's own microbatch's). Call it after
    ``tensor_parallelize`` and before FSDP2 wraps the model."""
    from torch import nn

    from maggy_tpu_torch.parallel.mesh import expert_group, mesh_shape
    from maggy_tpu_torch.parallel.sharding import batch_group_axes
    from maggy_tpu_torch.parallel.spec import AXIS_EXPERT, AXIS_STAGE, AXIS_TENSOR

    shape = mesh_shape(mesh)
    ep = shape.get(AXIS_EXPERT, 1)
    tp = shape.get(AXIS_TENSOR, 1)
    axes = batch_group_axes(shape) if shape.get(AXIS_STAGE, 1) == 1 else ()
    place = ExpertPlacement(
        ep=ep,
        rank=mesh.get_local_rank(AXIS_EXPERT) if ep > 1 else 0,
        group=expert_group(mesh) if ep > 1 else None,
        batch_groups=tuple(mesh.get_group(a) for a in axes),
        n_batch=math.prod(shape[a] for a in axes),
        tp=tp,
        tensor_group=mesh.get_group(AXIS_TENSOR) if tp > 1 else None,
    )
    for _, block in moe_blocks(model):
        e = block.cfg.n_experts
        if e % ep:
            raise ValueError(
                f"n_experts={e} not divisible by ep={ep}: the expert axis would silently replicate "
                "instead of sharding the expert FFNs"
            )
        n = e // ep
        for w in EXPERT_WEIGHTS if ep > 1 else ():
            full = getattr(block, w)
            local = local_weight(full.detach())[place.rank * n:(place.rank + 1) * n].clone()
            if hasattr(full, "to_local"):  # its hidden width sharded over `tensor` already
                from torch.distributed.tensor import DTensor

                local = DTensor.from_local(local, full.device_mesh, full.placements, run_check=False)
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
