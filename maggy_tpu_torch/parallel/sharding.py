"""Logical-axis sharding rules, applied to a ``Decoder`` on a DeviceMesh.

The port's copy of the rule tables of :mod:`maggy_tpu.parallel.sharding`
and a counterpart of its ``params_shardings``: every Decoder parameter
carries the JAX package's logical axis names (:func:`logical_axes`), the
rules map them to mesh axes, and :func:`shard_decoder` lays the model out:

* ``tensor``: DTensor ``parallelize_module``. A projection whose output
  dim maps to ``tensor`` is ``ColwiseParallel`` (``wq``, ``wk``, ``wv``,
  ``w_gate``, ``w_up``, ``lm_head``), one whose input dim does is
  ``RowwiseParallel`` (``wo``, ``w_down``); the embedding table is sharded
  over the vocabulary. ``lm_head``'s logits are gathered over ``tensor``
  (fp32 logits whole on every rank, for the loss), as are the embedding's
  rows. The norm scales are DTensors replicated over ``tensor``, so every
  parameter lies on one mesh. An MoE block's expert weights are DTensors
  on the tensor mesh too, sharded over their ``mlp`` dim (``Shard(2)`` for
  ``w_gate``/``w_up``, ``Shard(1)`` for ``w_down``), and its router a
  replicated one; :func:`~maggy_tpu_torch.parallel.expert.expert_parallelize`
  then keeps this rank's experts of each shard.
* ``fsdp`` (and ``data``): FSDP2 ``fully_shard`` per ``DecoderLayer``,
  then on the root, over the (``data``, ``fsdp``) sub-mesh: HSDP,
  replicated over ``data`` and sharded over ``fsdp``, when ``dp > 1``;
  on a one-rank mesh too (its ``fsdp`` axis at extent 1), but not under
  ``tp`` alone. On a sliced mesh the replicas are (``slice``, ``data``)
  (:func:`slice_rules`: the batch spans the slices, no parameter does):
  sharded over ``fsdp`` inside a slice, replicated across slices.
  Gradients are reduced as a sum, not FSDP2's mean (see ``Trainer.step``).
* ``seq`` lays out no parameter: they are replicated over it (as JAX's
  rules replicate them), each ``seq`` rank differentiates its chunk of
  the sequence, and ``Trainer.step`` sums the gradients over the ``seq``
  group after the backward, on top of FSDP2's reduction.
* On a pure ``data`` mesh whose trainer runs the bucketed or ZeRO-1 step
  (:mod:`~maggy_tpu_torch.parallel.overlap`) :func:`shard_decoder` is not
  called: the trainer reduces the gradients over ``data`` itself.
* Under pp (a ``stage`` axis above 1) each rank holds one pipeline stage
  and :func:`shard_decoder` is not called either: the stage gets
  :func:`tensor_parallelize` over ``tensor`` alone (an MoE stage then
  :func:`~maggy_tpu_torch.parallel.expert.expert_parallelize` over
  ``expert`` and ``tensor``), its parameters are replicated over ``data``
  and ``fsdp`` as JAX's are, and the pipeline sums their gradients over
  both.

Two deliberate divergences from the JAX layout (ROADMAP "Deliberate
divergences"): ``wk``/``wv`` are column-parallel too (``kv`` maps to
``tensor`` here, where JAX replicates it), so each rank holds its own
``n_kv_heads/tp`` KV heads, the slice JAX's ``sharded_flash_attention``
takes out anyway, and their gradients need no reduction over ``tensor``;
and FSDP2 shards every parameter's dim 0 over ``fsdp`` (norm scales too),
not the dim named ``embed``. Where a tensor-parallel extent does not divide
a dim, JAX replicates that dim and attends through XLA; the port has no
such fallback and raises up front.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

from maggy_tpu_torch.parallel.spec import AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQ, AXIS_SLICE, AXIS_TENSOR

# the JAX package's DEFAULT_RULES: logical name -> mesh axis (or a tuple of
# mesh axes, or None for replicated); kept to hold PORT_RULES against
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", (AXIS_DATA, AXIS_FSDP)),
    ("activation_seq", AXIS_SEQ),
    ("embed", AXIS_FSDP),
    ("mlp", AXIS_TENSOR),
    ("heads", AXIS_TENSOR),
    ("kv", None),
    ("vocab", AXIS_TENSOR),
    ("expert", AXIS_EXPERT),
    ("norm", None),
    ("conv_spatial", None),
    ("conv_in", None),
    ("conv_out", AXIS_FSDP),
)
# what the port lays out, its only table: the KV projections follow
# ``tensor`` too
PORT_RULES: Tuple[Tuple[str, Any], ...] = tuple(
    (name, AXIS_TENSOR if name == "kv" else axis) for name, axis in DEFAULT_RULES
)

# the mesh axes a batch's rows may be split over, outer to inner
BATCH_AXES = (AXIS_SLICE, AXIS_DATA, AXIS_FSDP)


def slice_rules(rules=DEFAULT_RULES) -> Tuple[Tuple[str, Any], ...]:
    """The rule table of a sliced mesh (JAX's ``slice_rules``): ``batch``
    spans the outer ``slice`` axis as well; every other rule is unchanged,
    so no parameter is sharded over ``slice`` and a reshape re-places the
    same parameters on fewer or more slices."""
    out = []
    for name, axis in rules:
        if name == "batch":
            cur = tuple(axis) if isinstance(axis, (tuple, list)) else ((axis,) if axis is not None else ())
            axis = (AXIS_SLICE,) + cur
        out.append((name, axis))
    return tuple(out)


# Decoder parameter names (PyTorch's [out, in] layout) -> the logical axes
# of each dim, the JAX Decoder's names (models/transformer.py: wq/wk/wv
# ("embed", "heads"|"kv", None), wo ("heads", None, "embed"), w_gate/w_up
# ("embed", "mlp"), w_down ("mlp", "embed"), embedding ("vocab", "embed"),
# lm_head ("embed", "vocab"), norm scales ("norm",)) in that layout
_DECODER_AXES = (
    (r"embedding", ("vocab", "embed")),
    (r"layers\.\d+\.(attn_norm|mlp_norm)\.scale", ("norm",)),
    (r"final_norm\.scale", ("norm",)),
    (r"layers\.\d+\.attn\.wq\.weight", ("heads", "embed")),
    (r"layers\.\d+\.attn\.w[kv]\.weight", ("kv", "embed")),
    (r"layers\.\d+\.attn\.wo\.weight", ("embed", "heads")),
    (r"layers\.\d+\.mlp\.w_(gate|up)\.weight", ("mlp", "embed")),
    (r"layers\.\d+\.mlp\.w_down\.weight", ("embed", "mlp")),
    (r"lm_head\.weight", ("vocab", "embed")),
    # the MoEDecoder's (models/moe.py): router kernel ("embed", None) as
    # [e, d]; the experts in JAX's own [experts, ...] layout
    (r"layers\.\d+\.moe\.router\.weight", (None, "embed")),
    (r"layers\.\d+\.moe\.w_(gate|up)", ("expert", "embed", "mlp")),
    (r"layers\.\d+\.moe\.w_down", ("expert", "mlp", "embed")),
)


def logical_to_mesh_axes(logical: Sequence[Optional[str]]) -> Tuple:
    """The mesh axes (under :data:`PORT_RULES`) of each logical axis."""
    table = dict(PORT_RULES)
    return tuple(table.get(name) if name is not None else None for name in logical)


def logical_axes(name: str) -> Tuple[str, ...]:
    """The logical axes of the Decoder parameter ``name`` (a
    ``named_parameters()`` key, FSDP2's and DTensor's too)."""
    for pattern, axes in _DECODER_AXES:
        if re.fullmatch(pattern, name):
            return axes
    raise KeyError(f"no logical axes for Decoder parameter {name!r}")


def placed_mesh_axes(param) -> frozenset:
    """The mesh axes (of extent > 1) a parameter is actually sharded over:
    those of its DTensor placements that shard a dim (``tensor`` on an MoE
    expert weight's ``mlp`` dim too), and ``expert`` for an MoE expert
    weight that holds its rank's experts alone
    (:mod:`~maggy_tpu_torch.parallel.expert`)."""
    from maggy_tpu_torch.parallel.expert import expert_extent

    axes = {AXIS_EXPERT} if expert_extent(param) > 1 else set()
    mesh = getattr(param, "device_mesh", None)
    if mesh is None:
        return frozenset(axes)
    names = mesh.mesh_dim_names
    return frozenset(axes | {
        names[i] for i, p in enumerate(param.placements)
        if not (p.is_replicate() or p.is_partial()) and mesh.mesh.shape[i] > 1
    })


def check_tensor_parallel(cfg, tp: int) -> None:
    """Raise unless ``tp`` divides every dim tensor parallelism splits:
    the query and KV heads, the MLP width and the vocabulary."""
    if tp <= 1:
        return
    dims = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(
            f"tensor parallelism tp={tp} must divide {sorted(bad)} ({bad}); JAX would replicate "
            "those dims and attend through XLA, the port has no such fallback"
        )


def batch_group_axes(mesh_shape: Dict[str, int]) -> Tuple[str, ...]:
    """The mesh axes the batch is split over, of extent > 1."""
    return tuple(a for a in BATCH_AXES if mesh_shape.get(a, 1) > 1)


def fsdp_applies(mesh_shape: Dict[str, int]) -> bool:
    """Whether :func:`shard_decoder` applies FSDP2: whenever the batch is
    split, and on a mesh that splits nothing (one rank: its fsdp axis at
    extent 1, as JAX always has it); not under ``tensor`` alone."""
    return bool(batch_group_axes(mesh_shape)) or mesh_shape.get(AXIS_TENSOR, 1) == 1


def _replicated_inputs(mod, inputs, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return tuple(DTensor.from_local(x, mesh, [Replicate()], run_check=False) for x in inputs)


def _local_output(mod, output, mesh):
    return output.to_local()


def shard_decoder(model, mesh):
    """Lay ``model`` (a materialised ``Decoder`` or ``MoEDecoder``, the
    same weights on every rank) out on ``mesh`` in place and return it:
    tensor parallelism over ``tensor`` (an MoE block's expert weights
    over their hidden width), the MoE blocks' experts over ``expert``
    (:func:`~maggy_tpu_torch.parallel.expert.expert_parallelize`), then
    FSDP2 over (``data``, ``fsdp``). Every rank must call it.
    Afterwards each parameter is a DTensor (or, on a mesh with no axis
    above 1 that touches it, the plain tensor)."""
    from maggy_tpu_torch.parallel import expert
    from maggy_tpu_torch.parallel.mesh import mesh_shape

    shape = mesh_shape(mesh)
    tp = shape.get(AXIS_TENSOR, 1)
    check_tensor_parallel(model.cfg, tp)
    moe = expert.is_moe(model)
    if tp > 1:
        tensor_parallelize(model, mesh[AXIS_TENSOR])
    if moe:
        expert.expert_parallelize(model, mesh)
    if fsdp_applies(shape):
        from torch.distributed.fsdp import fully_shard

        from maggy_tpu_torch.parallel.mesh import replica_mesh

        replicas = replica_mesh(mesh)
        if replicas is None:
            fsdp_mesh = mesh[AXIS_FSDP]
        else:  # HSDP: replicated over (slice, data), sharded over fsdp
            fsdp_mesh = mesh[(replicas.mesh_dim_names[0], AXIS_FSDP)]
        for layer in model.layers:
            fully_shard(layer, mesh=fsdp_mesh)
        fully_shard(model, mesh=fsdp_mesh)
        for mod in model.modules():
            if hasattr(mod, "set_gradient_divide_factor"):
                # each rank differentiates its share of the global mean:
                # the gradients add up, FSDP2 must not average them; a
                # plain SUM (gloo has no pre-multiplied sum)
                mod.set_gradient_divide_factor(1.0)
                mod.set_force_sum_reduction_for_comms(True)
    if moe:
        expert.tag_expert_params(model)
    return model


def tensor_parallelize(model, tp_mesh):
    """Tensor parallelism over the one-dimensional ``tp_mesh``, in place:
    the projections by :data:`PORT_RULES` (``lm_head``'s logits gathered),
    the norm scales replicated DTensors, the embedding table (where the
    module has one) sharded over the vocabulary, and an MoE block's router
    replicated and its expert weights sharded over ``mlp``. ``model`` is a
    ``Decoder`` (an ``MoEDecoder``) or a pipeline stage of one: any module
    whose submodules carry the Decoder's parameter names."""
    from torch import nn
    from torch.distributed.tensor import Replicate, Shard, distribute_module, distribute_tensor
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    from maggy_tpu_torch.models.transformer import Dense, RMSNorm
    from maggy_tpu_torch.parallel.expert import EXPERT_WEIGHTS, moe_blocks

    plan = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, Dense):
            continue
        out_axis, in_axis = logical_to_mesh_axes(logical_axes(name + ".weight"))
        if out_axis == AXIS_TENSOR:
            # lm_head's vocab-sharded logits are gathered for the loss
            plan[name] = ColwiseParallel(output_layouts=Replicate()) if name == "lm_head" else ColwiseParallel()
        elif in_axis == AXIS_TENSOR:
            plan[name] = RowwiseParallel()
    parallelize_module(model, tp_mesh, plan)
    for mod in model.modules():
        if isinstance(mod, RMSNorm):
            # the scales replicated over `tensor` as DTensors, computed
            # locally on the replicated residual stream: every parameter
            # then lies on one mesh, as an optimizer's foreach kernels
            # need (one list cannot mix plain tensors and DTensors)
            distribute_module(mod, tp_mesh, input_fn=_replicated_inputs, output_fn=_local_output)
    for name, block in moe_blocks(model):
        # an MoE block's router replicated as the norms are (every tensor
        # rank routes the same bits), its expert weights sharded over their
        # hidden width (``mlp``), every expert still on this rank
        distribute_module(block.router, tp_mesh, input_fn=_replicated_inputs, output_fn=_local_output)
        for w in EXPERT_WEIGHTS:
            full = getattr(block, w)
            dim = logical_to_mesh_axes(logical_axes(f"{name}.{w}")).index(AXIS_TENSOR)
            setattr(block, w, nn.Parameter(distribute_tensor(full.detach(), tp_mesh, [Shard(dim)]),
                                           requires_grad=full.requires_grad))
    table = getattr(model, "embedding", None)
    if table is not None and logical_to_mesh_axes(logical_axes("embedding"))[0] == AXIS_TENSOR:
        model.embedding = nn.Parameter(distribute_tensor(table.detach(), tp_mesh, [Shard(0)]),
                                       requires_grad=table.requires_grad)
    return model
