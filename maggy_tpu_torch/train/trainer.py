"""Trainer: AdamW steps on one card, on a mesh of cards, or over a ring.

Counterpart of :mod:`maggy_tpu.train.trainer`: the LM and classification
losses, a ``TrainState``, a ``Trainer`` with ``make_state``, ``step``,
``eval_logits``, ``evaluate``, ``checkpoint_meta`` and ``fit``
(checkpoints, ``resume``, the preemption save, the input prefetcher, the
profiler window and the telemetry of the JAX ``fit``), and a
``TrainContext``. A context over a ``DeviceMesh`` (``dp``, ``fsdp``,
``sp``, ``tp``; one process per card) lays the ``Decoder`` out with FSDP2
and DTensor tensor parallelism (:mod:`maggy_tpu_torch.parallel.sharding`)
and splits each sequence over ``seq`` (ring attention,
:mod:`maggy_tpu_torch.parallel.ringattention`, or Ulysses,
:mod:`maggy_tpu_torch.parallel.ulysses`); on a pure ``dp`` mesh,
``zero_stage``/``bucket_mb`` select the bucketed and ZeRO-1 steps of
:mod:`maggy_tpu_torch.parallel.overlap`; a ``stage`` axis above 1 trains
the Decoder in pipeline stages on the 1F1B schedule
(:mod:`maggy_tpu_torch.parallel.pipeline`,
:mod:`maggy_tpu_torch.train.pipeline_adapter`). The MoEDecoder trains
under all of these but the ``seq`` axis and a ring: its experts over
``expert``, their hidden width over ``tensor``
(:mod:`maggy_tpu_torch.parallel.expert`), its router terms in the
objective and in every pipeline stage. A sliced context
(:meth:`TrainContext.create_sliced`) adds the outer ``slice`` axis, and
``Trainer(membership=)`` checks the elastic membership at each step
boundary of ``fit``. The autopilot (ROADMAP queue 1 item 9) belongs to a
later slice of the port.

Where the JAX step is a pure function returning a new state, ``step``
updates the parameters and optimizer in place and returns the same state
object. Metrics stay device tensors until a caller reads them, so the host
never waits on the card inside the loop unless it asks for a value.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from maggy_tpu_torch.parallel import overlap
from maggy_tpu_torch.parallel import sharding as shd
from maggy_tpu_torch.parallel.expert import expert_extent, expert_params, is_moe
from maggy_tpu_torch.parallel.mesh import any_rank, from_rank0, host_group, mesh_shape, seq_group, stage_group
from maggy_tpu_torch.parallel.ringattention import LocalRing, ProcessGroupRing
from maggy_tpu_torch.parallel.spec import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_SEQ,
    AXIS_SLICE,
    AXIS_STAGE,
    AXIS_TENSOR,
    ShardingSpec,
    SliceTopology,
)
# JAX keeps the one-time overlap warning in its pipeline adapter; so does
# the port, and this module re-exports it
from maggy_tpu_torch.train.pipeline_adapter import warn_overlap_unbucketed
from maggy_tpu_torch.util import resolve_device

Batch = Dict[str, Any]


def _prefetch_depth(prefetch: Optional[int]) -> int:
    """Resolve an input-prefetch depth: an explicit argument wins, else the
    ``MAGGY_TPU_PREFETCH`` env knob, else 2 (double-buffered). 0 disables."""
    if prefetch is not None:
        return max(0, int(prefetch))
    try:
        return max(0, int(os.environ.get("MAGGY_TPU_PREFETCH", "2")))
    except ValueError:
        return 2


def _lm_loss_parts(
    logits: torch.Tensor, batch: Batch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(masked log-likelihood sum, mask weight)`` for the LM objective —
    the sufficient statistics :func:`lm_loss_fn` normalizes."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    mask = _effective_mask(batch)
    if mask is None:
        return ll.sum(), torch.tensor(float(ll.numel()), device=ll.device)
    return (ll * mask).sum(), mask.sum()


def _effective_mask(batch: Batch) -> Optional[torch.Tensor]:
    """:func:`lm_loss_fn`'s target mask of a (sub)batch, ``loss_mask`` and
    same-segment, or None when the batch has neither (every target counts)."""
    mask = batch.get("loss_mask")
    mask = None if mask is None else mask[:, 1:].float()
    seg = batch.get("segment_ids")
    if seg is not None:
        same = (seg[:, 1:] == seg[:, :-1]).float()
        mask = same if mask is None else mask * same
    return mask


def lm_loss_fn(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    """Next-token cross entropy over ``batch["tokens"]`` with optional
    ``batch["loss_mask"]``. With ``batch["segment_ids"]`` (packed sequences)
    the boundary positions — where the target token belongs to a different
    segment than its predictor — are masked out automatically."""
    ll_sum, weight = _lm_loss_parts(logits, batch)
    return -ll_sum / torch.clamp(weight, min=1.0)


def shard_sequence(batch: Batch, rank: int, n: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s chunk of a global LM batch split over ``n`` ranks
    along the sequence: its ``tokens``, ``positions`` (``rank*C + arange(C)``
    or the packed positions) and ``segment_ids``, plus the ``targets`` and
    ``loss_weights`` of :func:`_lm_loss_parts` computed from the GLOBAL
    batch. The loss shifts tokens across the whole sequence (the last
    position of chunk r predicts the first token of chunk r+1), so no rank
    can shift its own chunk alone; the sequence's last position gets weight
    0. A batch that already carries ``targets`` is returned as it is."""
    if "targets" in batch:
        return batch
    tokens = np.asarray(batch["tokens"])
    b, s = tokens.shape
    if s % n:
        raise ValueError(f"sequence length {s} does not divide into {n} equal ring chunks")
    c = s // n
    chunk = slice(rank * c, (rank + 1) * c)
    targets = np.zeros_like(tokens)
    targets[:, :-1] = tokens[:, 1:]
    weights = np.zeros((b, s), np.float32)
    weights[:, :-1] = 1.0
    if batch.get("loss_mask") is not None:
        weights[:, :-1] *= np.asarray(batch["loss_mask"], np.float32)[:, 1:]
    seg = batch.get("segment_ids")
    if seg is not None:
        seg = np.asarray(seg)
        weights[:, :-1] *= seg[:, 1:] == seg[:, :-1]
    positions = batch.get("positions")
    if positions is None:
        positions = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    out = {
        "tokens": tokens[:, chunk],
        "positions": np.asarray(positions)[:, chunk],
        "targets": targets[:, chunk],
        "loss_weights": weights[:, chunk],
    }
    if seg is not None:
        out["segment_ids"] = seg[:, chunk]
    return out


def _shard_for(ring, batch: Batch) -> Batch:
    """This rank's chunk of a global batch under a ProcessGroupRing; the
    batch itself under a LocalRing or no ring."""
    if isinstance(ring, ProcessGroupRing):
        return shard_sequence(batch, ring.rank, ring.size)
    return batch


def _split_of(mesh, ring) -> Optional[Tuple[int, int, Any]]:
    """``(this rank's chunk, chunks, group)`` when each rank holds a chunk
    of the sequence: the ``seq`` axis of a mesh, or a ProcessGroupRing."""
    if mesh is not None:
        n = mesh_shape(mesh).get(AXIS_SEQ, 1)
        return (mesh.get_local_rank(AXIS_SEQ), n, seq_group(mesh)) if n > 1 else None
    if isinstance(ring, ProcessGroupRing):
        return ring.rank, ring.size, ring.group
    return None


def shard_rows(batch: Batch, mesh) -> Batch:
    """This rank's rows of a global batch on ``mesh``: the rows split over
    (``slice``, ``data``, ``fsdp``), outer first, as JAX's ``batch`` rule
    places them; ranks that differ only along other axes get the same
    rows."""
    shape = mesh_shape(mesh)
    index, blocks = 0, 1
    for axis in shd.BATCH_AXES:
        n = shape.get(axis, 1)
        index = index * n + (mesh.get_local_rank(axis) if n > 1 else 0)
        blocks *= n
    out = {}
    for key, value in batch.items():
        rows = value.shape[0]
        if rows % blocks:
            raise ValueError(
                f"batch[{key!r}] has {rows} rows, which do not split over the {blocks} (slice x data x fsdp) ranks"
            )
        per = rows // blocks
        out[key] = value[index * per:(index + 1) * per]
    return out


def _chunk_lm_loss_parts(logits: torch.Tensor, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log-likelihood sum, weight)`` of one chunk from the targets and
    weights :func:`shard_sequence` took from the global batch; summed over
    the ranks they are :func:`_lm_loss_parts` of the global batch."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    weights = batch["loss_weights"].float()
    return (ll * weights).sum(), weights.sum()


# gradients are summed over a sequence split in buckets of about this size
ALL_REDUCE_BUCKET_BYTES = 256 << 20


@torch.no_grad()
def _all_reduce_sum(tensors, group, bucket_bytes: int = ALL_REDUCE_BUCKET_BYTES) -> None:
    """Sum ``tensors`` in place over ``group`` in few calls, in the buckets
    :func:`~maggy_tpu_torch.parallel.overlap.plan_buckets` cuts (one dtype
    each, up to ``bucket_bytes``): each is flattened, reduced at once and
    copied back; a bucket of one tensor is reduced in place, with no copy.
    Each element is summed as a call per tensor would sum it."""
    import torch.distributed as dist

    tensors = list(tensors)
    for b in overlap.plan_buckets(tensors, bucket_bytes / 2**20).buckets:
        bucket = [tensors[i] for i in b.indices]
        if len(bucket) == 1:
            dist.all_reduce(bucket[0], group=group)
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, part in zip(bucket, flat.split(b.sizes)):
            t.copy_(part.view_as(t))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, under no_grad), or the
    tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def _global_norm(grads, holders: Optional[int] = None, splits=None) -> torch.Tensor:
    """The L2 norm of every gradient, whole, as a plain tensor equal on
    every rank: each rank sums the squares of the shards it holds, each
    divided by the number of ranks holding that shard (a DTensor's
    replicas, or every rank holding the tensor: ``holders``, by default the
    world; a pipeline stage's ranks under pp; ``splits`` gives, per
    gradient, the ranks that hold other parts of it outside its own mesh:
    the ``expert`` extent of an expert weight), and one all-reduce over
    the world adds them up."""
    import torch.distributed as dist

    world = dist.get_world_size()
    dtensor = sys.modules.get("torch.distributed.tensor")
    total = None
    for i, g in enumerate(grads):
        copies = (holders or world) // (splits[i] if splits is not None else 1)
        if dtensor is not None and isinstance(g, dtensor.DTensor):
            for extent, placement in zip(g.device_mesh.mesh.shape, g.placements):
                if not (placement.is_replicate() or placement.is_partial()):  # Shard, FSDP2's strided shard
                    copies //= extent
            g = g.to_local()
        sq = g.detach().float().square().sum() / copies
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("no gradients to take the norm of")
    dist.all_reduce(total)
    return total.sqrt()


def collect_aux_losses(model: nn.Module, device=None) -> torch.Tensor:
    """The sum of every auxiliary loss ``model``'s last forward left in its
    modules (the MoE router terms: each block's ``aux_loss``), as a 0-d
    fp32 tensor; zero for a model that has none (on ``device``, else its
    parameters'). THE one collecting rule, as JAX's ``collect_aux_losses``:
    the train steps and the tests all read the terms through it."""
    aux = None
    for mod in model.modules():
        term = getattr(mod, "aux_loss", None)
        if isinstance(term, torch.Tensor):
            aux = term.float() if aux is None else aux + term.float()
    if aux is None:
        if device is None:
            device = next(model.parameters()).device
        aux = torch.zeros((), dtype=torch.float32, device=device)
    return aux


def classification_loss_fn(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def _model_inputs(batch: Batch) -> Tuple:
    if "tokens" in batch:
        args = [batch["tokens"]]
        # packed sequences: optional positions (restarting per segment) and
        # segment_ids ride through to the model's extra positional args
        if "positions" in batch or "segment_ids" in batch:
            args.append(batch.get("positions"))
            if "segment_ids" in batch:
                args.append(batch["segment_ids"])
        return tuple(args)
    if "inputs" in batch:
        return (batch["inputs"],)
    raise KeyError("Batch must contain 'tokens' (LM) or 'inputs' (generic)")


@dataclasses.dataclass
class TrainState:
    """The parameters (held by ``model``), the optimizer and its state, and
    the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the bucketed or ZeRO-1 step's reduction state
    # (:class:`~maggy_tpu_torch.parallel.overlap.OverlapLayout`); None on
    # the dense path
    layout: Any = None
    # under pp: this rank's stage and the parts
    # (:class:`~maggy_tpu_torch.train.pipeline_adapter.PipelineLayout`);
    # ``model`` is then the stage (a ``DecoderStage``)
    pipeline: Any = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


@dataclasses.dataclass
class Trainer:
    """Dense training of ``model`` on one device.

    ``optimizer`` is a factory called on the parameters, such as
    :func:`maggy_tpu_torch.train.adamw`. ``device`` defaults to CUDA and
    raises when there is none; pass ``device="cpu"`` to run on the CPU.

    ``ring`` is the sequence-parallel ring the model attends over (see
    :class:`TrainContext`). A :class:`LocalRing` runs every rank in this
    process, so the step is the dense one. Under a
    :class:`ProcessGroupRing` each process holds one chunk of the sequence
    (:meth:`shard_batch`): the step sums the loss parts and the gradients
    over the group, so the loss is the global masked mean exactly and the
    replicated parameters stay identical on every rank.

    ``mesh`` is a ``DeviceMesh`` with the JAX package's axis names
    (:func:`~maggy_tpu_torch.parallel.mesh.make_mesh`), one process per
    device: ``make_state`` lays the ``Decoder`` out on it and each rank
    steps on its rows of the global batch (:meth:`shard_batch`). The loss
    is the global token-weighted mean, as JAX's over the whole batch: each
    rank differentiates its log-likelihood sum over the global weight and
    the gradients are summed, so ranks holding different token weights
    (packed ``segment_ids``, a ``loss_mask``) are weighted exactly. A
    mesh whose ``seq`` axis is above 1 splits each row's sequence over it
    as well (the model attends through ring or Ulysses attention over that
    axis): the gradients are then also summed over ``seq`` after the
    backward, so the grad norm counts each gradient once. ``ring`` may
    then be the :class:`ProcessGroupRing` over that axis
    (:meth:`ProcessGroupRing.over_mesh`).

    ``zero_stage`` (0 or 1) and ``bucket_mb`` (MiB; None or inf:
    unbucketed) are JAX's overlap knobs (:meth:`_overlap_mode`). On a mesh
    whose only axis above 1 is ``data`` they select the bucketed step
    (each bucket all-reduced over ``data`` as backward fills it) or the
    ZeRO-1 step (each bucket reduce-scattered, AdamW on this rank's flat
    shard, the parameters all-gathered back), both in
    :mod:`~maggy_tpu_torch.parallel.overlap`; there FSDP2 does not wrap the
    model. Elsewhere they stay off with JAX's one-time warning.

    A mesh whose ``stage`` axis is above 1 (``pp``) trains the Decoder in
    stages: each rank holds one :class:`~maggy_tpu_torch.train.
    pipeline_adapter.DecoderStage` (its layers; the embedding on stage 0,
    the final norm and ``lm_head`` on the last) and ``step`` runs
    :func:`~maggy_tpu_torch.parallel.pipeline.pipeline_grads_1f1b` over
    ``n_microbatches`` microbatches (default ``2 * pp``) of its rows. As in
    JAX, stage parameters are replicated over ``data`` and ``fsdp`` (no
    FSDP2: their gradients are all-reduced over both, in
    :func:`~maggy_tpu_torch.parallel.overlap.plan_buckets` buckets), laid
    out over ``tensor`` by the DTensor rules of :mod:`~maggy_tpu_torch.parallel.sharding`, and a masked or packed
    loss is rescaled to the dense global token-weighted mean. ``pp`` with
    ``sp`` is refused, as JAX's is. An MoEDecoder's stages add their router
    terms at each backward tick (``aux_loss``: the sum over the stages of
    each microbatch's term, averaged as the loss is), its experts split over
    ``expert`` and ``tensor`` inside each stage.

    On a sliced mesh (:meth:`TrainContext.create_sliced`) the batch is
    split over ``slice`` as well and the gradients are summed across the
    slices. ``membership`` (a
    :class:`~maggy_tpu_torch.resilience.membership.MembershipMonitor`) makes
    ``fit`` check the elastic membership at each step boundary
    (:meth:`_membership_check`)."""

    model: nn.Module
    optimizer: Callable[..., torch.optim.Optimizer]
    device: Any = None
    loss_fn: Callable = lm_loss_fn
    ring: Any = None
    # elastic membership: a MembershipMonitor, checked at fit's step boundaries
    membership: Optional[Any] = None
    mesh: Any = None
    zero_stage: int = 0
    bucket_mb: Optional[float] = None
    # pipeline parallelism: microbatches a step when the mesh's stage axis
    # is above 1 (None: 2 * pp); must divide each batch rank's rows
    n_microbatches: Optional[int] = None

    def __post_init__(self):
        if self.zero_stage not in (0, 1):
            raise ValueError(f"Trainer.zero_stage must be 0 or 1, got {self.zero_stage!r}")
        if self.bucket_mb is not None and not float(self.bucket_mb) > 0:
            raise ValueError(f"Trainer.bucket_mb must be positive (or None), got {self.bucket_mb!r}")
        self.device = resolve_device(self.device)
        if self.ring is not None and not isinstance(self.ring, (LocalRing, ProcessGroupRing)):
            raise TypeError(f"ring must be a LocalRing or a ProcessGroupRing, got {type(self.ring).__name__}")
        if self.mesh is not None and self.ring is not None:
            n = self._mesh_shape.get(AXIS_SEQ, 1)
            if not isinstance(self.ring, ProcessGroupRing) or self.ring.size != n:
                raise ValueError(
                    f"a ring under a mesh is the ProcessGroupRing over its seq axis ({n} ranks; "
                    "ProcessGroupRing.over_mesh(mesh)), got a "
                    f"{type(self.ring).__name__} of {self.ring.size}"
                )
        self._split = _split_of(self.mesh, self.ring)
        if self._split is not None and self.loss_fn is not lm_loss_fn:
            raise NotImplementedError(
                "a trainer over a split sequence trains the LM loss only (its targets cross chunks)"
            )
        self._overlap_memo = None
        self._overlap_layout = None
        self._pp_parts = None
        if is_moe(self.model):
            self._check_moe()
        if self.mesh is not None and self.pp == 1:  # under pp, make_state raises JAX's refusals
            cfg = getattr(self.model, "cfg", None)
            if cfg is None or not hasattr(self.model, "layers"):
                raise NotImplementedError(
                    f"a mesh lays out the Decoder and the MoEDecoder; {type(self.model).__name__} on a mesh "
                    "comes with its model family (ROADMAP queue 1 item 8)"
                )
            # a head count tp does not divide raises here, before anything
            # is built, on any device
            shd.check_tensor_parallel(cfg, self._mesh_shape.get(AXIS_TENSOR, 1))
        self._layout_memo = None

    def _check_moe(self) -> None:
        """Refuse what an MoE model cannot train on yet: a sequence split
        (a ring, or ``seq``; ROADMAP queue 1 item 8c), and an ``expert``
        extent that does not divide the experts. ``tensor`` and pipeline
        stages train it, alone and with ``expert``."""
        shape = self._mesh_shape
        unported = [f"{a}={shape[a]}" for a in (AXIS_SEQ,) if shape.get(a, 1) > 1]
        if self.ring is not None:
            unported.append(f"a {type(self.ring).__name__}")
        if unported:
            raise NotImplementedError(
                f"the MoEDecoder under {', '.join(unported)} (MoE with sequence parallelism: the ring, Ulysses, "
                "the seq axis) is ROADMAP queue 1 item 8c, not ported yet"
            )
        ep = shape.get(AXIS_EXPERT, 1)
        if self.model.cfg.n_experts % ep:
            raise ValueError(
                f"n_experts={self.model.cfg.n_experts} not divisible by ep={ep}: the expert axis would "
                "silently replicate instead of sharding the expert FFNs"
            )

    @property
    def _group_ring(self) -> Optional[ProcessGroupRing]:
        return self.ring if isinstance(self.ring, ProcessGroupRing) else None

    @property
    def _mesh_shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh) if self.mesh is not None else {}

    # ---------------------------------------------------------------- pipeline

    @property
    def pp(self) -> int:
        """Pipeline stages: the mesh's ``stage`` extent (1: off)."""
        return self._mesh_shape.get(AXIS_STAGE, 1)

    def _n_micro(self) -> int:
        return self.n_microbatches or 2 * self.pp

    def _pipeline_parts(self):
        """The Decoder's pipeline parts for this mesh, built once; raises
        JAX's refusals (pp with sp, and those of
        :func:`~maggy_tpu_torch.train.pipeline_adapter.decoder_pipeline_parts`)."""
        if self._pp_parts is None:
            from maggy_tpu_torch.train.pipeline_adapter import decoder_pipeline_parts

            shape = self._mesh_shape
            if shape.get(AXIS_SEQ, 1) > 1:
                raise ValueError(
                    "pp>1 does not compose with sp>1: the 1F1B schedule runs each stage op under a lax.cond whose "
                    "predicate varies per stage, and a seq-ring collective inside a non-uniform cond deadlocks "
                    "(verified on the CPU mesh). Use pp x tp / pp x ep / pp x dp/fsdp, or sp without pp."
                )
            self._pp_parts = decoder_pipeline_parts(self.model, self.pp, tp=shape.get(AXIS_TENSOR, 1),
                                                    mesh=self.mesh, ep=shape.get(AXIS_EXPERT, 1))
        return self._pp_parts

    @property
    def _dpf(self) -> int:
        shape = self._mesh_shape
        return math.prod(shape.get(a, 1) for a in shd.BATCH_AXES)

    def _batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch ranks (``slice``, ``data``, ``fsdp``)."""
        import torch.distributed as dist

        t = t.clone()
        for axis in shd.batch_group_axes(self._mesh_shape):
            dist.all_reduce(t, group=self.mesh.get_group(axis))
        return t

    def _pp_batch_parts(self, batch: Batch, parts, n_micro: int):
        """JAX's shared plumbing of the pipelined step and evaluation:
        this rank's rows cut into ``n_micro`` microbatches, the raw channel
        stream (packed positions and segment ids ride as int channels, so
        every stage masks and positions its attention), the targets, and
        the last stage's loss, rescaled for a masked or packed batch so the
        microbatch losses add up to the dense global token-weighted mean.
        Returns ``(raw microbatches, targets, loss_pp, activation)``."""
        tokens = _model_inputs(batch)[0]
        rows, dpf = tokens.shape[0], self._dpf
        if rows % n_micro:
            raise ValueError(
                f"batch size {rows * dpf} does not split into n_microbatches={n_micro} microbatches of whole rows "
                f"on each of the mesh's data x fsdp extent ({dpf}) ranks ({rows} rows a rank); set "
                "Trainer(n_microbatches=...) to a divisor or grow the batch"
            )

        def split(a):
            return a.reshape((n_micro, rows // n_micro) + tuple(a.shape[1:]))

        tgts = {k: split(v) for k, v in batch.items()}
        mask_norm = None
        if self.loss_fn is lm_loss_fn:
            m = _effective_mask(batch)
            if m is not None:
                # the global effective-mask sum: per-microbatch masked means
                # rescaled by it add up to the dense objective
                mask_norm = torch.clamp(self._batch_sum(m.sum()), min=1.0)

        def loss_pp(stage, y, tgt):
            loss = self.loss_fn(parts.head_fn(stage, y), tgt)
            if mask_norm is not None:
                local = torch.clamp(_effective_mask(tgt).sum(), min=1.0)
                # the schedule divides the sum of these by dpf * n_micro
                loss = loss * local * (dpf * n_micro) / mask_norm
            return loss

        if "segment_ids" in batch or "positions" in batch:
            positions = batch.get("positions")
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
            channels = [tokens, positions.to(tokens.dtype)]
            if batch.get("segment_ids") is not None:
                channels.append(batch["segment_ids"].to(tokens.dtype))
            raw = torch.stack(channels, dim=-1)
        else:
            raw = tokens
        cfg = self.model.cfg
        activation = ((rows // n_micro, tokens.shape[1], cfg.d_model), cfg.dtype)
        return split(raw), tgts, loss_pp, activation

    def _pp_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The pipelined train step: 1F1B over this rank's microbatches,
        the gradients summed over the batch ranks, the grad norm over every
        stage, each parameter counted once, then AdamW on this stage. The
        loss is every rank's (summed over the stages and batch ranks).
        ``n_microbatches`` is read at each step: a change takes effect at
        the next one (nothing is compiled)."""
        from maggy_tpu_torch.parallel.pipeline import pipeline_grads_1f1b

        import torch.distributed as dist

        parts = self._pipeline_parts()
        raw, tgts, loss_pp, activation = self._pp_batch_parts(self._to_device(batch), parts, self._n_micro())
        state.optimizer.zero_grad(set_to_none=True)
        out = pipeline_grads_1f1b(parts.stage_fn, loss_pp, state.model, raw, tgts, mesh=self.mesh,
                                  first_fn=parts.first_fn, stage_takes_raw=True, stage_has_aux=parts.stage_has_aux,
                                  activation=activation)
        loss = out[0]
        # an MoE stage's router terms: each microbatch's, summed over the
        # stages and averaged as the loss is (JAX's metric semantics)
        aux = out[2] if parts.stage_has_aux else torch.zeros((), dtype=torch.float32, device=loss.device)
        params = [p for p in state.model.parameters() if p.grad is not None]
        # an expert weight's shard is held once on each of its expert ranks
        gnorm = _global_norm([p.grad for p in params], holders=dist.get_world_size() // self.pp,
                             splits=[expert_extent(p) for p in params])
        state.optimizer.step()
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": loss + aux, "grad_norm": gnorm,
                   "step": torch.tensor(state.step)}
        state.step += 1
        return state, metrics

    def _make_pipeline_state(self, seed_or_generator, params) -> TrainState:
        """This rank's stage, its weights the Decoder's own (the stage's
        entries of ``params``, or the stage's share of the seeded draws),
        laid out over ``tensor`` where tp > 1, and its optimizer."""
        from maggy_tpu_torch.train.pipeline_adapter import PipelineLayout

        parts = self._pipeline_parts()
        self._overlap_mode()  # zero/bucket on a pp mesh: the one-time warning
        stage = self.mesh.get_local_rank(AXIS_STAGE)
        module = parts.make_stage(stage, self.device)
        if params is not None:
            module.load_state_dict(parts.restack(params)[stage])
        else:
            module.reset_parameters(self._generator(seed_or_generator))
        if self._mesh_shape.get(AXIS_TENSOR, 1) > 1:
            shd.tensor_parallelize(module, self.mesh[AXIS_TENSOR])
        if parts.stage_has_aux:  # MoE layers: experts over `expert`, hidden width over `tensor`
            from maggy_tpu_torch.parallel import expert

            expert.expert_parallelize(module, self.mesh)
            expert.tag_expert_params(module)
        return TrainState(module, self.optimizer(module.parameters()), 0,
                          pipeline=PipelineLayout(parts, stage, self.mesh))

    # ---------------------------------------------------------------- overlap

    def _bucket_mb_eff(self) -> Optional[float]:
        """``bucket_mb`` normalised: None or inf (one bucket per dtype) -> None."""
        if self.bucket_mb is None or not math.isfinite(float(self.bucket_mb)):
            return None
        return float(self.bucket_mb)

    def _overlap_mode(self) -> Tuple[str, Tuple[str, ...], int]:
        """Which step the configuration gets, resolved once:
        ``("off" | "bucket" | "zero", manual batch axes, zero shard count)``.

        ``zero_stage``/``bucket_mb`` request the overlap step, which reduces
        the gradients over ``data`` (then ``slice``) itself. It needs a mesh
        whose only axes above 1 are ``data`` and ``slice``: ``fsdp``, ``tensor``, ``seq`` or ``expert``
        above 1 (FSDP2 and DTensor lay those out; under fsdp the optimizer
        state is sharded already), or no ``data`` axis to reduce over, warn
        once and stay on the dense path, as JAX's does (a ring trainer
        counts as a ``seq`` axis, a trainer without a mesh as a mesh of one
        device)."""
        if self._overlap_memo is not None:
            return self._overlap_memo
        off = ("off", (), 1)
        requested = self.zero_stage > 0 or self._bucket_mb_eff() is not None
        if not requested:
            self._overlap_memo = off
            return off
        shape = self._mesh_shape or ({AXIS_SEQ: self.ring.size} if self.ring is not None else {})
        manual = tuple(a for a in (AXIS_SLICE, AXIS_DATA) if shape.get(a, 1) > 1)
        blockers = sorted(a for a in (AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ, AXIS_EXPERT) if shape.get(a, 1) > 1)
        mode = off
        if self.pp > 1:
            warn_overlap_unbucketed(
                f"pipeline mesh (stage={self.pp}): per-stage bucketing is not implemented, the 1F1B schedule "
                "keeps its own collectives"
            )
        elif blockers:
            warn_overlap_unbucketed(
                f"mesh axes {blockers} are laid out by FSDP2, DTensor or the sequence split; the overlap "
                "step needs a pure data mesh (fsdp already shards optimizer state)"
            )
        elif not manual:
            warn_overlap_unbucketed("no data/slice mesh axis > 1 to reduce over")
        else:
            dz = shape.get(AXIS_DATA, 1) if self.zero_stage > 0 else 1
            if self.zero_stage > 0 and dz == 1:
                import warnings

                warnings.warn(
                    "zero_stage=1 needs a data-axis extent > 1; optimizer "
                    "states stay replicated (effective zero_stage=0)",
                    stacklevel=3,
                )
            mode = ("zero" if dz > 1 else "bucket", manual, dz)
        self._overlap_memo = mode
        return mode

    def _overlap_state(self, model: nn.Module, mode: str, dz: int) -> TrainState:
        """The bucketed or ZeRO-1 state of ``model`` (materialised, the
        same weights on every rank, not laid out): the bucket plan over
        its parameters in JAX's flatten order, the per-bucket reduction
        hooks, and under ZeRO-1 the flat buffers and the optimizer over
        this rank's shards."""
        from maggy_tpu_torch import telemetry

        if self._overlap_layout is not None:  # a state made before: its hooks go
            self._overlap_layout.remove()
        params = dict(model.named_parameters())
        names = overlap.jax_leaf_order(list(params))
        leaves = [params[n] for n in names]
        plan = overlap.plan_buckets(leaves, self._bucket_mb_eff(), pad_to=dz)
        telemetry.get().gauge("train.bucket_count", len(plan.buckets))
        # reduced over data, then over slice (over slice alone when data is 1)
        shape = self._mesh_shape
        inner = AXIS_DATA if shape.get(AXIS_DATA, 1) > 1 else AXIS_SLICE
        group, rank = self.mesh.get_group(inner), self.mesh.get_local_rank(inner)
        outer = self.mesh.get_group(AXIS_SLICE) if inner == AXIS_DATA and shape.get(AXIS_SLICE, 1) > 1 else None
        zero = overlap.ZeroShards(leaves, plan, group, dz, rank) if mode == "zero" else None
        grads = overlap.BucketedGrads(leaves, plan, group, shards=dz, rank=rank, outer=outer)
        layout = overlap.OverlapLayout(mode, plan, names, group, dz, rank, grads, zero)
        self._overlap_layout = layout
        optimizer = self.optimizer(zero.shards if zero is not None else model.parameters())
        return TrainState(model, optimizer, 0, layout=layout)

    # ------------------------------------------------------------------ batches

    def shard_batch(self, batch: Batch, *, local: bool = False) -> Batch:
        """Under a mesh: this rank's rows of a global batch (every rank
        passes the same batch), or, with ``local=True``, the batch a
        rank-sharding loader already cut for this rank, as it is; then,
        when the mesh splits the sequence over ``seq``, the rows' chunk
        (:func:`shard_sequence`). Under a :class:`ProcessGroupRing`: this
        rank's chunk of the sequence. Otherwise the batch itself."""
        if self.mesh is None:
            return _shard_for(self.ring, batch)
        rows = batch if local else shard_rows(batch, self.mesh)
        split = self._split
        return rows if split is None else shard_sequence(rows, split[0], split[1])

    def batch_shardings(self, batch: Batch) -> Dict[str, Tuple]:
        """Each batch leaf's placement: per dim, the mesh axes that split it
        (rows over (``data``, ``fsdp``), the sequence over ``seq``, the
        rest whole)."""
        rows = shd.batch_group_axes(self._mesh_shape)
        seq = (AXIS_SEQ,) if self._mesh_shape.get(AXIS_SEQ, 1) > 1 else None
        out = {}
        for k, v in batch.items():
            dims = [rows or None] + [None] * (np.ndim(v) - 1)
            if len(dims) > 1:
                dims[1] = seq
            out[k] = tuple(dims)
        return out

    def _losses(self, logits: torch.Tensor, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(this rank's term to differentiate, the loss)``. Under a
        split sequence or a mesh that splits the batch, the loss parts are
        all-reduced over every rank holding other tokens: each rank
        differentiates its own log-likelihood over the global weight."""
        split = self._split
        if split is not None:
            if "targets" not in batch:
                raise ValueError("a step over a split sequence takes Trainer.shard_batch(global_batch)")
            ll_sum, weight = _chunk_lm_loss_parts(logits, batch)
            groups = [split[2]] + [self.mesh.get_group(a) for a in shd.batch_group_axes(self._mesh_shape)]
        elif self.mesh is not None and shd.batch_group_axes(self._mesh_shape):
            if self.loss_fn is lm_loss_fn:
                ll_sum, weight = _lm_loss_parts(logits, batch)
            else:  # a mean over this rank's rows, weighted by them
                rows = float(next(iter(batch.values())).shape[0])
                weight = torch.tensor(rows, device=logits.device)
                ll_sum = -self.loss_fn(logits, batch) * rows
            groups = [self.mesh.get_group(a) for a in shd.batch_group_axes(self._mesh_shape)]
        else:
            loss = self.loss_fn(logits, batch)
            return loss, loss
        import torch.distributed as dist

        parts = torch.stack([ll_sum.detach(), weight.float()])
        for group in groups:
            dist.all_reduce(parts, group=group)
        denom = torch.clamp(parts[1], min=1.0)
        return -ll_sum / denom, -parts[0] / denom

    # ------------------------------------------------------------------ state

    def make_state(
        self,
        seed_or_generator: Union[int, torch.Generator],
        sample_batch: Batch,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> TrainState:
        """Materialise the model on the device and build the optimizer.
        Weights come from ``params`` (a ``state_dict``, e.g. from
        :func:`maggy_tpu_torch.convert.decoder_params_from_flax`) when given,
        else from the model's ``reset_parameters(generator)``.

        Under a mesh every rank materialises the full weights first, from
        ``params`` or the same seeded generator, so a sharded run starts
        from exactly the weights of a dense one; only then is the model
        laid out on the mesh (:func:`~maggy_tpu_torch.parallel.sharding.
        shard_decoder`) and the optimizer built over the shards.

        Under pp the state holds this rank's stage alone (a
        ``DecoderStage`` in ``TrainState.model``, the trainer's model left
        as it is): its share of ``params``, or of the seeded draws of the
        whole Decoder, so the stages together hold a dense run's weights."""
        _model_inputs(sample_batch)  # the batch names the model's inputs
        if self.pp > 1:
            return self._make_pipeline_state(seed_or_generator, params)
        model = self.model
        if any(p.is_meta for p in model.parameters()):
            model.to_empty(device=self.device)
        else:
            model.to(self.device)
        if params is not None:
            model.load_state_dict(params)
        else:
            model.reset_parameters(self._generator(seed_or_generator))
        ring = self._group_ring
        if ring is not None and self.mesh is None:  # the parameters are replicated: rank 0's everywhere
            import torch.distributed as dist

            src = dist.get_global_rank(ring.group, 0) if ring.group is not None else 0
            with torch.no_grad():
                for p in model.parameters():
                    dist.broadcast(p, src, group=ring.group)
        if self.mesh is not None:
            mode, _, dz = self._overlap_mode()
            if mode != "off":  # the trainer reduces over data itself: no FSDP2
                return self._overlap_state(model, mode, dz)
            shd.shard_decoder(model, self.mesh)
        return TrainState(model, self.optimizer(model.parameters()), 0)

    def _generator(self, seed_or_generator: Union[int, torch.Generator]) -> torch.Generator:
        """The generator weights are drawn from: the one given, or one on
        this trainer's device seeded with the int."""
        if isinstance(seed_or_generator, torch.Generator):
            return seed_or_generator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed_or_generator))
        return gen

    def state_shardings_for(self, sample_batch: Optional[Batch] = None) -> Dict[str, Tuple]:
        """Each parameter's layout on the mesh, from the rules and the
        shapes alone (nothing is allocated): ``{name: per dim, the mesh
        axes that split it}``; the optimizer's moments follow their
        parameter. FSDP2 splits dim 0 over ``fsdp`` (``data`` replicates),
        tensor parallelism the dim the port's rules map to ``tensor``, and an
        MoE expert weight's expert dim lies over ``expert`` first. Under
        pp: the parameters of this rank's stage, over ``tensor`` only."""
        if self._layout_memo is not None:
            return self._layout_memo
        shape = self._mesh_shape
        fsdp = self.mesh is not None and shd.fsdp_applies(shape) and shape.get(AXIS_FSDP, 1) > 1
        named = self.model.named_parameters()
        if self.pp > 1:  # this rank's stage, replicated over data and fsdp as in JAX
            fsdp = False
            named = self._pipeline_parts().make_stage(self.mesh.get_local_rank(AXIS_STAGE), "meta").named_parameters()
        ep = shape.get(AXIS_EXPERT, 1) if is_moe(self.model) else 1
        out = {}
        for name, p in named:
            dims = [[] for _ in range(p.dim())]
            if ep > 1 and shd.logical_axes(name)[0] == "expert":
                dims[0].append(AXIS_EXPERT)  # this rank's experts, then FSDP2's dim 0 of them
            if fsdp and dims:
                dims[0].append(AXIS_FSDP)
            if shape.get(AXIS_TENSOR, 1) > 1:
                for i, axis in enumerate(shd.logical_to_mesh_axes(shd.logical_axes(name))):
                    if axis == AXIS_TENSOR:
                        dims[i].append(axis)
            out[name] = tuple(tuple(d) or None for d in dims)
        self._layout_memo = out
        return out

    def adopt_state(self, state, sample_batch: Batch) -> TrainState:
        """Place a foreign state (a dense one, or one restored elsewhere)
        onto this trainer's layout: its full parameters and optimizer
        state, sharded here, at its step. Under pp ``state`` may also be a
        pipeline state of this trainer's degree: ``{"step", "params",
        "optimizer", "hyper"}``, each of the first two a list of one
        :func:`~maggy_tpu_torch.train.pipeline_adapter.stage_state` entry a
        stage (what
        :func:`~maggy_tpu_torch.train.pipeline_adapter.convert_pipeline_state`
        returns); each rank takes its stage's."""
        if self.pp > 1:
            return self._adopt_pipeline_state(state, sample_batch)
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
            get_optimizer_state_dict,
            set_optimizer_state_dict,
        )

        if state.layout is not None:
            raise ValueError("adopt_state takes a dense state; a ZeRO-1 or bucketed state moves through a "
                             "checkpoint (restore_zero_compat)")
        # full on every rank: each lays out its own shards from it
        full = StateDictOptions(full_state_dict=True)
        params = get_model_state_dict(state.model, options=full)
        optim = get_optimizer_state_dict(state.model, state.optimizer, options=full)
        mine = self.make_state(0, sample_batch, params=params)
        for name, (_, place) in expert_params(mine.model).items():  # this rank's experts' moments
            n = mine.model.cfg.n_experts // place.ep
            optim["state"][name] = {k: v[place.rank * n:(place.rank + 1) * n] if v.dim() else v
                                    for k, v in optim["state"][name].items()}
        if mine.layout is None:
            set_optimizer_state_dict(mine.model, mine.optimizer, optim, options=full)
        else:  # the dense optimizer state in the checkpoint's form, converted to this layout
            from maggy_tpu_torch.train.checkpoint import _DENSE_ZERO, _copy_layout, convert_zero_payload

            names = [name for name, _ in mine.model.named_parameters()]
            index = {name: i for i, name in enumerate(names)}
            payload = {
                "step": state.step,
                "params": {name: params[name] for name in names},
                "optimizer": {
                    "state": {index[name]: v for name, v in optim["state"].items()},
                    "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                                     for g in optim["param_groups"]],
                },
            }
            _copy_layout(mine, convert_zero_payload(payload, saved=_DENSE_ZERO,
                                                    live=self.checkpoint_meta()["zero"]))
        mine.step = state.step
        return mine

    def _adopt_pipeline_state(self, state, sample_batch: Batch) -> TrainState:
        if isinstance(state, TrainState):
            if state.layout is not None or state.pipeline is not None:
                raise ValueError("adopt_state under pp takes a dense state or a pipeline state dict; a ZeRO-1, "
                                 "bucketed or pipeline TrainState moves through a checkpoint")
            params = {n: p.detach() for n, p in state.model.named_parameters()}
            index = {p: n for n, p in state.model.named_parameters()}
            optim = {index[p]: dict(v) for p, v in state.optimizer.state.items()}
            hyper = {k: v for k, v in state.optimizer.param_groups[0].items() if k != "params"}
            state = {"step": state.step, "params": [params], "optimizer": [optim], "hyper": hyper}
            parts = self._pipeline_parts()
            state.update(params=parts.restack(params), optimizer=parts.restack(optim))
        if len(state["params"]) != self.pp:
            raise ValueError(
                f"a pipeline state of {len(state['params'])} stages on a pp={self.pp} trainer: re-stage it "
                "with convert_pipeline_state first"
            )
        from maggy_tpu_torch.train.pipeline_adapter import load_stage_state

        stage = self.mesh.get_local_rank(AXIS_STAGE)
        mine = self.make_state(0, sample_batch, params=state["params"][stage])
        load_stage_state(mine, {"step": state["step"], "params": state["params"][stage],
                                      "optimizer": state["optimizer"][stage], "hyper": state["hyper"]})
        return mine

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    # ------------------------------------------------------------------ steps

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One AdamW step; metrics as in the JAX dense step. Under a
        ProcessGroupRing or a mesh the batch is this rank's
        :meth:`shard_batch`; under pp the step is the 1F1B pipeline's."""
        if self.pp > 1:
            return self._pp_step(state, batch)
        batch = self._to_device(batch)
        logits = state.model(*_model_inputs(batch))
        term, loss = self._losses(logits, batch)
        del logits
        layout = state.layout
        # the router terms of an MoE model (zero for the Decoder): on a mesh
        # its blocks take their statistics over the global batch already,
        # so every rank holds the global term; the bucketed and ZeRO-1 steps
        # see this rank's rows alone and average the ranks' terms, as JAX's
        aux = collect_aux_losses(state.model, loss.device)
        aux_term = aux
        if layout is not None and is_moe(state.model):
            aux_term = aux / self._dpf
            aux = self._batch_sum(aux.detach()) / self._dpf
        total = loss + aux.detach()
        state.optimizer.zero_grad(set_to_none=True)
        if layout is not None:
            layout.grads.begin()
        (term + aux_term).backward()
        aux = aux.detach()
        if layout is not None:
            gnorm = layout.update(state.optimizer)
        else:
            params = [p for p in state.model.parameters() if p.grad is not None]
            grads = [p.grad for p in params]
            split = self._split
            if split is not None:  # the global gradient is the sum of the chunks'
                with torch.no_grad():
                    _all_reduce_sum([_local(g) for g in grads], split[2])
            if self.mesh is not None:
                gnorm = _global_norm(grads, splits=[expert_extent(p) for p in params])
            else:
                gnorm = torch.nn.utils.get_total_norm(grads)
            state.optimizer.step()
        metrics = {
            "loss": loss.detach(),
            "aux_loss": aux,
            "total_loss": total.detach(),
            "grad_norm": gnorm,
            "step": torch.tensor(state.step),
        }
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_logits(self, state: TrainState, batch: Batch) -> torch.Tensor:
        """Full logits for one batch (this rank's chunk of them under a
        ProcessGroupRing, its rows under a mesh).

        MEMORY CAVEAT under pp, as in JAX: the stages are unstacked into a
        whole Decoder on every rank (:meth:`dense_model`), which holds
        every parameter at once — fine for tests and small models, a spike
        at the scale pipelines exist for. Prefer :meth:`evaluate` there."""
        model = self.dense_model(state) if self.pp > 1 else state.model
        batch = self._to_device(self.shard_batch(batch))
        return model(*_model_inputs(batch))

    @torch.no_grad()
    def dense_model(self, state: TrainState) -> nn.Module:
        """Under pp: the whole Decoder (an MoEDecoder for one) on this
        rank's device, its weights gathered from every stage (each stage's
        broadcast over the stage group, tensor shards and experts gathered
        first). Every rank must call it."""
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.expert import gather_expert_tensor

        pipe = state.pipeline
        group, parts = stage_group(self.mesh), pipe.parts
        mine = dict(state.model.named_parameters())
        experts = expert_params(state.model)
        full = {}
        for s in range(parts.n_stages):
            for name, p in parts.make_stage(s, "meta").named_parameters():
                if s == pipe.stage:
                    t = mine[name]
                    if name in experts:  # every expert, gathered over `expert` (and `tensor`)
                        t = gather_expert_tensor(t, experts[name][1])
                    t = (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().contiguous()
                else:
                    t = torch.empty(p.shape, dtype=p.dtype, device=self.device)
                dist.broadcast(t, dist.get_global_rank(group, s), group=group)
                full[name] = t
        model = type(self.model)(self.model.cfg, device="meta")
        model.to_empty(device=self.device)
        model.load_state_dict(full)
        return model

    @torch.no_grad()
    def evaluate(
        self,
        state: TrainState,
        data_iter,
        num_batches: int,
        prefetch: Optional[int] = None,
    ) -> Dict[str, float]:
        """Mean loss over ``num_batches`` held-out batches (no state update).

        As in the JAX trainer, the batches flow through a
        :class:`~maggy_tpu_torch.train.prefetch.DevicePrefetcher`
        (``prefetch`` batches ahead; ``MAGGY_TPU_PREFETCH`` sets the default,
        0 disables) capped at ``num_batches``, so the iterator is never
        over-consumed; the losses add up on the device and are read once at
        the end. Under pp the loss flows through the stages
        (:func:`~maggy_tpu_torch.parallel.pipeline.pipeline_forward_loss`):
        each rank holds its stage and one microbatch's activation, never
        the whole model."""
        if num_batches < 1:
            raise ValueError("evaluate needs num_batches >= 1")
        from maggy_tpu_torch import telemetry
        from maggy_tpu_torch.train.prefetch import DevicePrefetcher

        depth = min(_prefetch_depth(prefetch), num_batches)
        prefetcher = (
            DevicePrefetcher(
                data_iter,
                self.shard_batch,
                depth=depth,
                max_items=num_batches,
                telemetry_recorder=telemetry.get(),
                device=self.device,
            )
            if depth > 0
            else None
        )
        total = None
        try:
            for _ in range(num_batches):
                if prefetcher is not None:
                    batch = next(prefetcher)
                else:
                    batch = self.shard_batch(next(data_iter))
                batch = self._to_device(batch)
                if self.pp > 1:
                    loss = self._pp_eval_loss(state, batch)
                else:
                    loss = self._losses(state.model(*_model_inputs(batch)), batch)[1]
                total = loss if total is None else total + loss
        finally:
            if prefetcher is not None:
                prefetcher.close()
        return {"loss": float(total) / num_batches}

    def _pp_eval_loss(self, state: TrainState, batch: Batch) -> torch.Tensor:
        from maggy_tpu_torch.parallel.pipeline import pipeline_forward_loss

        parts = self._pipeline_parts()
        raw, tgts, loss_pp, activation = self._pp_batch_parts(batch, parts, self._n_micro())
        loss, _ = pipeline_forward_loss(parts.stage_fn, loss_pp, state.model, raw, tgts, mesh=self.mesh,
                                        first_fn=parts.first_fn, stage_takes_raw=True,
                                        stage_has_aux=parts.stage_has_aux, activation=activation)
        return loss

    def checkpoint_meta(self) -> Dict[str, Any]:
        """The active system configuration, recorded by ``Checkpointer.save``
        beside every state this trainer checkpoints; restores compare it
        with the live trainer's and warn on a mismatch. The keys are the
        JAX trainer's: the mesh's axes of extent above 1 (the ring's ``sp``
        under a ring; ``stage`` under pp), the devices and processes,
        ``n_microbatches``, the model's compute dtype and the effective ZeRO
        layout (what ``restore_zero_compat`` converts across)."""
        import torch.distributed as dist

        ring = self.ring
        sp = ring.size if ring is not None else 1
        cfg = getattr(self.model, "cfg", None)
        mode, _, dz = self._overlap_mode()
        if self.mesh is not None:
            mesh_axes = {k: v for k, v in self._mesh_shape.items() if v > 1}
            num_devices = self.mesh.size()
        else:
            mesh_axes = {"sp": sp} if sp > 1 else {}
            num_devices = ring.size if isinstance(ring, ProcessGroupRing) else 1
        return {
            "mesh_axes": mesh_axes,
            "num_devices": num_devices,
            "n_processes": dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1,
            "n_microbatches": self.n_microbatches,
            "dtype": str(getattr(cfg, "dtype", None)) if cfg is not None else None,
            "zero": {
                "stage": 1 if mode == "zero" else 0,
                "bucket_mb": self._bucket_mb_eff() if mode == "zero" else None,
                "shards": dz,
            },
        }

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _membership_check(self, state: TrainState, step: int, checkpointer, chaos, tel) -> None:
        """The elastic membership's seam at a step boundary of ``fit``
        (JAX's ``_membership_check``). Raises one of the membership
        exceptions when the mesh must reshape; the distributed executor's
        reshape loop catches it, waits at the driver's barrier, re-forms
        the group at the new width and re-enters the train_fn, which
        resumes from the latest complete checkpoint.

        * A **pending epoch** (another member's event, delivered by the
          heartbeat's ``RESHAPE`` reply) and a chaos **slice_rejoin** are
          graceful: one synchronous save at the current step first, so no
          step re-runs.
        * A chaos **slice_drop** is abrupt: nothing is saved, and the
          reshaped run falls back to the last periodic checkpoint.

        Under a mesh of several ranks, heartbeat replies reach the ranks at
        different times: the ranks first agree (one gloo all-reduce of the
        pending epoch and the chaos outcome, a MAX over the ranks) so that
        every rank takes the same decision at the same step."""
        import torch.distributed as dist

        from maggy_tpu_torch.resilience.membership import MembershipChanged, SliceLost, SliceRejoin

        mem = self.membership
        pending = mem.pending_epoch()
        dropped = joined = None
        if pending is None and chaos is not None:
            # a sliced group runs every active slice, so any may drop here;
            # a worker-mode process is one slice and only its own loss can
            # originate locally
            self_slice = mem.self_slice
            dropped = chaos.slice_drop(mem.active if self_slice is None else (self_slice,), step=step)
            if dropped is None and self_slice is None:
                joined = chaos.slice_rejoin(mem.inactive, step=step)
        if self.mesh is not None and dist.get_world_size() > 1:
            seen = torch.tensor([-1 if v is None else int(v) for v in (pending, dropped, joined)])
            dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=host_group())
            pending, dropped, joined = (None if v < 0 else v for v in seen.tolist())
        if pending is not None:
            event: BaseException = MembershipChanged(pending)
        elif dropped is not None:
            raise SliceLost(dropped, step=step)
        elif joined is not None:
            event = SliceRejoin(joined, step=step)
        else:
            return
        if checkpointer is not None:
            # the reshape's convergence point: one synchronous save at the
            # current step, as the preemption hook takes
            checkpointer.save(step, state, meta=self.checkpoint_meta())
            checkpointer.wait()
            tel.count("resilience.reshape_checkpoints")
        raise event

    def fit(
        self,
        state: TrainState,
        data_iter,
        num_steps: int,
        reporter=None,
        report_every: int = 10,
        metric_key: str = "loss",
        metric_sign: float = 1.0,
        checkpointer=None,
        checkpoint_every: int = 0,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (3, 6),
        resume: Optional[Any] = None,
        prefetch: Optional[int] = None,
        metrics_window: int = 2,
        autopilot: Optional[Any] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Host loop: step, and at step boundaries broadcast
        ``metric_sign * metrics[metric_key]`` to a duck-typed
        ``reporter.broadcast(value, step=)`` (where an early stop can
        interrupt). The JAX ``fit``'s signature and meaning:

        * ``checkpointer`` + ``checkpoint_every`` save the state every that
          many steps (:class:`~maggy_tpu_torch.train.checkpoint.Checkpointer`,
          asynchronous: the loop waits only for the copy to host memory).
        * ``resume="auto"`` restores the checkpointer's latest step over
          ``state`` (an int restores that step) and fast-forwards
          ``data_iter`` by the steps already taken (``skip(n)`` where the
          loader has it), so the trajectory continues where the interrupted
          run left off; ``num_steps`` stays the TOTAL budget, and the result
          carries ``resumed_from``. With no checkpoint, it is a fresh run.
        * With a checkpointer, a preemption notice (SIGTERM, or
          :func:`maggy_tpu_torch.resilience.preemption.request`) makes the
          loop take one synchronous save at the current step and return
          early with ``preempted = 1.0``.
        * Under a mesh every rank calls ``fit`` alike: the checkpoint is
          rank 0's (``resume="auto"`` takes rank 0's latest step), and a
          notice on any rank makes every rank save and return at the same
          step (the flag is reduced over the ranks on the host each step).
        * With ``membership`` each step boundary first runs
          :meth:`_membership_check`, which raises when the elastic
          membership moves (after one synchronous save, unless a slice was
          lost); a membership counts ``resilience.reshape_checkpoints``.
        * ``prefetch`` (default 2; ``MAGGY_TPU_PREFETCH`` overrides, 0
          disables): batches flow through a
          :class:`~maggy_tpu_torch.train.prefetch.DevicePrefetcher`, which
          runs ``shard_batch`` and the host-to-device copy that many batches
          ahead on a background thread. Consumption is capped at the steps
          to run, so a shared iterator keeps its position; only an early
          exit leaves up to ``prefetch`` extra batches consumed.
        * ``profile_dir`` records a ``torch.profiler`` trace over
          ``profile_steps=(start, stop)`` and writes it there as a Chrome
          trace.
        * ``autopilot`` is not ported yet (ROADMAP queue 1 item 9) and
          raises.

        Lagged metrics drain: a broadcast reads the metrics of the step that
        just left a ``metrics_window``-deep window, so the host reads a value
        the card finished long ago and does not stall the queue of work;
        ``metrics_window=0`` broadcasts the current step's value. The
        ``metrics_lag`` gauge records the realised lag.

        Telemetry, under the JAX package's names, into the ambient recorder
        (:func:`maggy_tpu_torch.telemetry.get`): a ``train_step`` span and a
        ``step_time_ms`` gauge each step; ``compile_time_ms`` for the first
        step, synchronised once — on the card that is warm-up (kernel and
        library loading, the allocator's first blocks), not compilation;
        ``step_time_ms_mean``, ``steps_per_sec``, ``tokens_per_sec`` and
        ``mfu_est`` at the end; ``metrics_drain_ms`` per broadcast read;
        ``resumed_step`` and the counters ``resilience.auto_resumes`` and
        ``resilience.preempt_saves``; the prefetcher's ``input_wait_ms`` and
        ``prefetch_depth``; a memory ledger (params, optimizer, staged
        batches) reconciled on the time series' ~1 s tick; a flight-recorder
        watchdog beat each step; and one trace per run with
        ``train.run_start`` and ``train.run_end`` events. The returned
        metrics carry the measured ``steps_per_sec`` (wall time after the
        final read, which waits for the card) whatever the telemetry flag.
        """
        from maggy_tpu_torch import telemetry
        from maggy_tpu_torch.resilience import chaos as _chaos
        from maggy_tpu_torch.resilience import preemption as _preemption
        from maggy_tpu_torch.telemetry import flightrec as _flightrec
        from maggy_tpu_torch.telemetry import memtrack as _memtrack
        from maggy_tpu_torch.telemetry import timeseries as _timeseries
        from maggy_tpu_torch.telemetry import tracing as _tracing
        from maggy_tpu_torch.train.prefetch import DevicePrefetcher, skip_batches

        if autopilot is not None and autopilot is not False:
            raise NotImplementedError("fit(autopilot=...) is not ported yet (ROADMAP queue 1 item 9)")
        tel = telemetry.get()
        resumed_from = None
        skipped = 0
        if resume is not None:
            if checkpointer is None:
                raise ValueError("fit(resume=...) requires a checkpointer")
            target = checkpointer.latest_step() if resume == "auto" else int(resume)
            if self.mesh is not None:  # the checkpoint is rank 0's (Checkpointer)
                target = from_rank0(target)
            if target is not None and target > state.step:
                from maggy_tpu_torch.train.checkpoint import restore_zero_compat

                start = state.step
                state = restore_zero_compat(
                    checkpointer,
                    state,
                    step=None if resume == "auto" else target,
                    live_meta=self.checkpoint_meta(),
                )
                resumed_from = state.step
                skipped = resumed_from - start
                # the interrupted run consumed one batch per completed step
                skip_batches(data_iter, skipped)
                tel.count("resilience.auto_resumes")
                tel.gauge("resumed_step", resumed_from)
        # num_steps is the TOTAL budget; a resumed fit runs the remainder
        num_steps = max(0, num_steps - skipped)
        # a preemption notice -> one final synchronous save + early return;
        # armed only when there is a checkpointer to save into
        hook = _preemption.install() if checkpointer is not None else None
        chaos = _chaos.get()
        step0 = state.step
        preempted = False
        metrics: Dict[str, torch.Tensor] = {}
        profiler = None
        prof_start = min(profile_steps[0], max(0, num_steps - 2))
        prof_stop = min(profile_steps[1], num_steps - 1)
        # the training tier's device-memory accounts, reconciled against the
        # card on the series tick
        ledger = _memtrack.MemoryLedger()
        ledger.register("params", _memtrack.array_bytes(state.params))
        ledger.register("optimizer", _memtrack.array_bytes(state.optimizer.state))
        depth = _prefetch_depth(prefetch)
        prefetcher = None
        if depth > 0 and num_steps > 0:
            prefetcher = DevicePrefetcher(
                data_iter,
                self.shard_batch,
                depth=depth,
                max_items=num_steps,
                telemetry_recorder=tel,
                ledger=ledger,
                device=self.device,
            )
        window = max(0, int(metrics_window))
        pending: deque = deque()  # (loop index, in-flight metrics)
        ready = None  # newest entry aged out of the window
        last_bcast = -1
        fit_t0 = time.perf_counter()
        tokens_per_batch = 0
        step_ms_sum = 0.0
        run_trace = _tracing.new_trace_id()
        trace_prev = _tracing.current()
        _tracing.set_current(run_trace)
        tel.event(
            "train.run_start", trace=run_trace, num_steps=num_steps,
            resumed_from=resumed_from, step0=step0,
        )
        wd = _flightrec.get()
        wd.begin("train.step", detail=step0)
        ts_store = _timeseries.SeriesStore()
        try:
            for i in range(num_steps):
                wd.beat("train.step", detail=step0 + i)
                if self.membership is not None:
                    # a pending epoch or a chaos slice event interrupts the
                    # loop at this step boundary; the graceful ones save the
                    # current step first, so no step re-runs
                    self._membership_check(state, step0 + i, checkpointer, chaos, tel)
                if chaos is not None:
                    # deterministic fault injection: a matching kill rule
                    # raises WorkerLost here
                    chaos.kill(tel.worker, step=step0 + i)
                if hook is not None and (
                    any_rank(hook.requested()) if self.mesh is not None else hook.requested()
                ):  # under a mesh every rank saves, whichever got the notice
                    checkpointer.save(step0 + i, state, meta=self.checkpoint_meta())
                    checkpointer.wait()
                    tel.count("resilience.preempt_saves")
                    preempted = True
                    break
                if profile_dir is not None and profiler is None and i == prof_start:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                if prefetcher is not None:
                    sharded = next(prefetcher)
                else:
                    batch = next(data_iter)
                    with tel.span("shard_batch", step=i):
                        sharded = self.shard_batch(batch)
                if i == 0 and isinstance(sharded, dict) and "tokens" in sharded:
                    tokens_per_batch = int(np.prod(sharded["tokens"].shape))
                t0 = time.perf_counter()
                with tel.span("train_step", step=i):
                    state, metrics = self.step(state, sharded)
                    if i == 0 and tel.active:
                        self._sync()  # the first sample covers the warm-up
                dt_ms = (time.perf_counter() - t0) * 1e3
                if i == 0:
                    tel.gauge("compile_time_ms", dt_ms)
                else:
                    step_ms_sum += dt_ms
                    tel.gauge("step_time_ms", dt_ms)
                if ts_store.maybe_sample(tel):
                    ledger.register("params", _memtrack.array_bytes(state.params))
                    ledger.register("optimizer", _memtrack.array_bytes(state.optimizer.state))
                    ledger.tick(store=ts_store, telemetry=tel, now=time.time())
                pending.append((i, metrics))
                while len(pending) > max(1, window):
                    ready = pending.popleft()
                if profiler is not None and profile_dir is not None and i >= prof_stop:
                    self._sync()
                    profiler.stop()
                    _export_trace(profiler, profile_dir)
                    profiler = None
                    profile_dir = None  # one capture per fit
                if reporter is not None and (i + 1) % report_every == 0:
                    src = pending[-1] if window == 0 else ready
                    if (src is None or src[0] <= last_bcast) and i == num_steps - 1:
                        src = pending[0]  # final boundary: window not primed
                    if src is not None and src[0] > last_bcast:
                        j, lagged = src
                        last_bcast = j
                        tel.gauge("metrics_lag", i - j)
                        t_drain = time.perf_counter()
                        value = metric_sign * float(lagged[metric_key])
                        tel.gauge("metrics_drain_ms", (time.perf_counter() - t_drain) * 1e3)
                        reporter.broadcast(value, step=step0 + j + 1)
                if checkpointer is not None and checkpoint_every and (i + 1) % checkpoint_every == 0:
                    checkpointer.save(step0 + i + 1, state, meta=self.checkpoint_meta())
        finally:
            wd.end("train.step")
            _tracing.set_current(trace_prev)
            if prefetcher is not None:
                prefetcher.close()
            if profiler is not None:  # the loop ended or raised inside the window
                profiler.stop()
        tel.event("train.run_end", trace=run_trace, steps=num_steps, preempted=preempted)
        out = {k: float(v) for k, v in metrics.items()}
        if resumed_from is not None:
            out["resumed_from"] = float(resumed_from)
        if preempted:
            out["preempted"] = 1.0
        # measured after the float() reads above, which wait for the card
        wall = time.perf_counter() - fit_t0
        if num_steps > 0 and wall > 0:
            out["steps_per_sec"] = num_steps / wall
            tel.gauge("steps_per_sec", out["steps_per_sec"])
            if num_steps > 1 and step_ms_sum > 0:
                tel.gauge("step_time_ms_mean", step_ms_sum / (num_steps - 1))
            if tokens_per_batch and tel.active:
                from maggy_tpu_torch.telemetry import flops as _flops

                tok_per_sec = tokens_per_batch * num_steps / wall
                tel.gauge("tokens_per_sec", tok_per_sec)
                mfu = _flops.estimate_mfu(tok_per_sec, _flops.param_count(state.model), [self.device])
                if mfu is not None:
                    tel.gauge("mfu_est", mfu)
        return state, out


def _export_trace(profiler, profile_dir: str) -> str:
    """Write a finished profiler window as a Chrome trace under
    ``profile_dir``; returns the file's path."""
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    profiler.export_chrome_trace(path)
    return path


def _group_size(who: str) -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{who} needs an initialised torch.distributed process "
            "group; use TrainContext.local for a ring inside one process"
        )
    return dist.get_world_size()


def _resolve_spec(spec_or_preset: Union[ShardingSpec, str], size: int) -> ShardingSpec:
    """A preset resolved against ``size`` ranks, or a spec scaled to them."""
    if isinstance(spec_or_preset, str):
        return ShardingSpec.preset(spec_or_preset, size)
    return spec_or_preset if spec_or_preset.num_devices == size else spec_or_preset.scaled_to(size)


def _rank_device(devices, device) -> torch.device:
    """This rank's device, made current on a card: ``devices[0]`` (the
    rank's lease), else ``device``, else ``cuda:LOCAL_RANK``, else the
    current card."""
    if devices:
        device = devices[0]
    if device is None and "LOCAL_RANK" in os.environ:  # else resolve_device takes the current card
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _require_ring(spec: ShardingSpec) -> None:
    if spec.sp < 2:
        raise ValueError(
            f"a local TrainContext runs sequence parallelism and needs sp > 1, got "
            f"sp={spec.sp}; a mesh spans one process per device (TrainContext.create), "
            "and one device trains with Trainer directly"
        )
    if spec.num_devices != spec.sp:
        raise ValueError(
            f"a local TrainContext runs the ring alone, in one process; {spec} spans a mesh of "
            "one process per device (TrainContext.create)"
        )


@dataclasses.dataclass
class TrainContext:
    """What a distributed ``train_fn`` is handed: the spec, the device, the
    mesh and, when ``sp > 1``, the ring over its ``seq`` axis.
    Counterpart of the JAX package's ``TrainContext``.

    ``create`` is the multi-card path, one process per rank over an
    initialised ``torch.distributed`` group (what
    ``lagom(train_fn, DistributedConfig(...))`` injects as ``ctx``);
    ``local`` runs every rank of a ring in this process (one card, or the
    CPU in tests). Under ``sp > 1`` the model names its attention itself:
    ``DecoderConfig(attention_fn=make_ring_attention(ctx.mesh))`` (or
    ``ctx.ring``) or ``make_ulysses_attention(ctx.mesh)``. A spec of
    ``sp`` alone trains over the ring without a mesh (parameters
    replicated, no FSDP2); with any other axis above 1 the trainer lays the model out on
    the mesh and splits each row's sequence over ``seq``.

    ``create_sliced`` builds a sliced mesh (the outer ``slice`` axis,
    ``topology``) over the ranks of the active slices; ``membership`` is the
    rank's :class:`~maggy_tpu_torch.resilience.membership.MembershipMonitor`
    under elastic membership, which the context's trainers check."""

    spec: ShardingSpec
    ring: Any
    device: torch.device
    mesh: Any = None
    process_index: int = 0
    num_processes: int = 1
    # "chief" (rank 0) / "worker" / "evaluator" — the reference's TF role
    # assignment (tf_dist_executor.py:138-144); an evaluator is outside the
    # training group (its own one-rank group) and should evaluate
    # checkpoints instead of training
    role: str = "worker"
    # elastic membership: the rank's MembershipMonitor and, for a sliced
    # mesh, the SliceTopology it was built for
    membership: Any = None
    topology: Optional[SliceTopology] = None

    @classmethod
    def create(cls, spec_or_preset: Union[ShardingSpec, str] = "fsdp", devices=None, role: str = "worker", *,
               device=None, membership=None) -> "TrainContext":
        """A context over the default process group, whose size the spec
        is scaled to (a preset is resolved against it): a DeviceMesh
        (:func:`~maggy_tpu_torch.parallel.mesh.make_mesh`) and, when
        ``sp > 1``, the :class:`ProcessGroupRing` over its ``seq`` axis.
        The device is ``devices[0]`` (this rank's lease), else ``device``,
        else ``cuda:LOCAL_RANK``, else the current card; ``device="cpu"``
        for gloo ranks."""
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.mesh import make_mesh, set_ambient_mesh

        size = _group_size("TrainContext.create")
        spec = _resolve_spec(spec_or_preset, size)
        device = _rank_device(devices, device)
        mesh = make_mesh(spec, device.type)
        set_ambient_mesh(mesh)
        ring = ProcessGroupRing.over_mesh(mesh) if spec.sp > 1 else None
        return cls(spec, ring, device, mesh=mesh, process_index=dist.get_rank(), num_processes=size, role=role,
                   membership=membership)

    @classmethod
    def create_sliced(cls, spec_or_preset: Union[ShardingSpec, str] = "fsdp", total_slices: int = 1, active=None,
                      devices=None, role: str = "worker", *, device=None, membership=None) -> "TrainContext":
        """A context over a sliced mesh (JAX's ``create_sliced``): the
        launch's ranks split into ``total_slices`` contiguous slices, and
        the default process group holds the ranks of the ``active`` ones
        (default: all), in slice order. Each slice runs ``spec_or_preset``
        (resolved against the ranks of one slice) under the outer ``slice``
        axis: the batch is split over (``slice``, ``data``, ``fsdp``)
        (:func:`~maggy_tpu_torch.parallel.sharding.slice_rules`), no
        parameter over ``slice``, so the gradients are reduced inside a
        slice, then summed across the slices. An elastic reshape re-forms
        the group over the surviving slices' ranks and calls this again
        with the surviving ``active`` set."""
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.mesh import make_slice_mesh, set_ambient_mesh, slice_device_groups

        size = _group_size("TrainContext.create_sliced")
        active = tuple(sorted(range(total_slices) if active is None else active))
        if not active:
            raise ValueError("create_sliced needs at least one active slice")
        if any(not 0 <= s < total_slices for s in active):
            raise ValueError(f"active slices {list(active)} lie outside the {total_slices} of the launch")
        slice_device_groups(len(active), range(size))  # raises unless the ranks split evenly
        spec = _resolve_spec(spec_or_preset, size // len(active))
        device = _rank_device(devices, device)
        topology = SliceTopology(n_slices=len(active), slice_spec=spec)
        mesh = make_slice_mesh(topology, device.type)
        set_ambient_mesh(mesh)
        ring = ProcessGroupRing.over_mesh(mesh) if spec.sp > 1 else None
        return cls(spec, ring, device, mesh=mesh, process_index=dist.get_rank(), num_processes=size, role=role,
                   membership=membership, topology=topology)

    @classmethod
    def local(cls, spec: ShardingSpec, device=None) -> "TrainContext":
        """A :class:`LocalRing` of ``spec.sp`` ranks in this process."""
        _require_ring(spec)
        return cls(spec, LocalRing(spec.sp), resolve_device(device))

    @property
    def _trainer_mesh(self):
        """The mesh the trainer lays the model out on: none for a ring
        alone (``sp`` the only axis above 1), which trains over its
        :class:`ProcessGroupRing` with the parameters replicated."""
        if self.mesh is None or (self.topology is None and self.spec.sp > 1
                                 and self.spec.num_devices == self.spec.sp):
            return None
        return self.mesh

    def trainer(self, model: nn.Module, optimizer, loss_fn: Callable = lm_loss_fn,
                n_microbatches: Optional[int] = None, zero_stage: Optional[int] = None,
                bucket_mb: Optional[float] = None) -> Trainer:
        """A Trainer over this context's mesh (or ring). The overlap knobs
        default to the spec's (``DistributedConfig`` stamps them there);
        explicit arguments win. ``n_microbatches`` is the pipeline's
        (``pp > 1``; default ``2 * pp``)."""
        if zero_stage is None:
            zero_stage = self.spec.zero_stage
        if bucket_mb is None:
            bucket_mb = self.spec.bucket_mb
        return Trainer(model, optimizer, device=self.device, loss_fn=loss_fn, ring=self.ring,
                       mesh=self._trainer_mesh, zero_stage=int(zero_stage), bucket_mb=bucket_mb,
                       n_microbatches=n_microbatches, membership=self.membership)

    def shard_batch(self, global_batch: Batch) -> Batch:
        """Every rank passes the same global batch and gets its own part:
        its rows under a mesh, then its chunk of their sequence when the
        mesh splits it over ``seq`` (:func:`shard_sequence`); its chunk of
        the sequence under a ring alone; with a LocalRing, the batch
        itself."""
        mesh = self._trainer_mesh
        if mesh is None:
            return _shard_for(self.ring, global_batch)
        split = _split_of(mesh, None)
        if split is None:
            return self.shard(global_batch)
        return shard_sequence(shard_rows(global_batch, mesh), split[0], split[1])

    def shard(self, tree: Batch, logical_axes=("batch",)) -> Dict[str, torch.Tensor]:
        """This rank's part of a host batch on its device: rows split over
        (``slice``, ``data``, ``fsdp``) as the ``batch`` rule places them;
        only that rule is ported."""
        if tuple(logical_axes) != ("batch",):
            raise NotImplementedError(f"TrainContext.shard places the 'batch' rule only, got {logical_axes}")
        if self.mesh is None:
            raise ValueError("TrainContext.shard needs a mesh; a ring context shards with shard_batch")
        rows = shard_rows(tree, self.mesh)
        return {k: torch.as_tensor(v).to(self.device) for k, v in rows.items()}
