"""Trainer: dense AdamW steps on one card, or sequence-parallel over a ring.

Counterpart of the dense path of :mod:`maggy_tpu.train.trainer`: the LM and
classification losses, a ``TrainState``, a ``Trainer`` with ``make_state``,
``step``, ``eval_logits``, ``evaluate`` and a minimal ``fit``, and a
``TrainContext`` for sequence parallelism (``ShardingSpec(sp=n)``), whose
model attends through :mod:`maggy_tpu_torch.parallel.ringattention`. The
other mesh axes, pipeline, overlap/ZeRO, autopilot, checkpoint, resume and
prefetch parts of the JAX trainer belong to later slices of the port.

Where the JAX step is a pure function returning a new state, ``step``
updates the parameters and optimizer in place and returns the same state
object. Metrics stay device tensors until a caller reads them, so the host
never waits on the card inside the loop unless it asks for a value.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from maggy_tpu_torch.parallel.ringattention import LocalRing, ProcessGroupRing
from maggy_tpu_torch.parallel.spec import ShardingSpec
from maggy_tpu_torch.util import resolve_device

Batch = Dict[str, Any]


def _lm_loss_parts(
    logits: torch.Tensor, batch: Batch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(masked log-likelihood sum, mask weight)`` for the LM objective —
    the sufficient statistics :func:`lm_loss_fn` normalizes."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = None if mask is None else mask[:, 1:].float()
    seg = batch.get("segment_ids")
    if seg is not None:
        same = (seg[:, 1:] == seg[:, :-1]).float()
        mask = same if mask is None else mask * same
    if mask is None:
        return ll.sum(), torch.tensor(float(ll.numel()), device=ll.device)
    return (ll * mask).sum(), mask.sum()


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


def _chunk_lm_loss_parts(logits: torch.Tensor, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log-likelihood sum, weight)`` of one chunk from the targets and
    weights :func:`shard_sequence` took from the global batch; summed over
    the ranks they are :func:`_lm_loss_parts` of the global batch."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    weights = batch["loss_weights"].float()
    return (ll * weights).sum(), weights.sum()


# gradients are summed over a ProcessGroupRing in buckets of about this size
ALL_REDUCE_BUCKET_BYTES = 256 << 20


def _all_reduce_sum(tensors, group, bucket_bytes: int = ALL_REDUCE_BUCKET_BYTES) -> None:
    """Sum ``tensors`` in place over ``group`` in few calls: consecutive
    tensors of one dtype are flattened into a bucket of up to
    ``bucket_bytes``, reduced at once and copied back; a tensor as large as
    a bucket is reduced alone, with no copy. Each element is summed as a
    call per tensor would sum it."""
    import torch.distributed as dist

    def flush(bucket):
        if len(bucket) == 1:
            dist.all_reduce(bucket[0], group=group)
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))

    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes or t.dtype != bucket[0].dtype):
            flush(bucket)
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        flush(bucket)


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
    replicated parameters stay identical on every rank."""

    model: nn.Module
    optimizer: Callable[..., torch.optim.Optimizer]
    device: Any = None
    loss_fn: Callable = lm_loss_fn
    ring: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.ring is not None and not isinstance(self.ring, (LocalRing, ProcessGroupRing)):
            raise TypeError(f"ring must be a LocalRing or a ProcessGroupRing, got {type(self.ring).__name__}")
        if self._group_ring and self.loss_fn is not lm_loss_fn:
            raise NotImplementedError(
                "a ProcessGroupRing trainer trains the LM loss only (its targets cross chunks)"
            )

    @property
    def _group_ring(self) -> Optional[ProcessGroupRing]:
        return self.ring if isinstance(self.ring, ProcessGroupRing) else None

    def shard_batch(self, batch: Batch) -> Batch:
        """This rank's chunk of a global batch under a
        :class:`ProcessGroupRing` (:func:`shard_sequence`); the batch itself
        otherwise."""
        return _shard_for(self.ring, batch)

    def _losses(self, logits: torch.Tensor, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(this rank's term to differentiate, the loss)``. Under a
        ProcessGroupRing the loss parts are all-reduced: each rank
        differentiates its own log-likelihood over the global weight."""
        ring = self._group_ring
        if ring is None:
            loss = self.loss_fn(logits, batch)
            return loss, loss
        import torch.distributed as dist

        if "targets" not in batch:
            raise ValueError("a ProcessGroupRing step takes Trainer.shard_batch(global_batch)")
        ll_sum, weight = _chunk_lm_loss_parts(logits, batch)
        parts = torch.stack([ll_sum.detach(), weight])
        dist.all_reduce(parts, group=ring.group)
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
        else from the model's ``reset_parameters(generator)``."""
        _model_inputs(sample_batch)  # the batch names the model's inputs
        model = self.model
        if any(p.is_meta for p in model.parameters()):
            model.to_empty(device=self.device)
        else:
            model.to(self.device)
        if params is not None:
            model.load_state_dict(params)
        else:
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(seed_or_generator))
            model.reset_parameters(gen)
        ring = self._group_ring
        if ring is not None:  # the parameters are replicated: rank 0's everywhere
            import torch.distributed as dist

            src = dist.get_global_rank(ring.group, 0) if ring.group is not None else 0
            with torch.no_grad():
                for p in model.parameters():
                    dist.broadcast(p, src, group=ring.group)
        return TrainState(model, self.optimizer(model.parameters()), 0)

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    # ------------------------------------------------------------------ steps

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One AdamW step; metrics as in the JAX dense step. Under a
        ProcessGroupRing the batch is this rank's :meth:`shard_batch`."""
        batch = self._to_device(batch)
        logits = state.model(*_model_inputs(batch))
        term, loss = self._losses(logits, batch)
        del logits
        # the dense decoder sows no auxiliary losses (MoE router terms)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        total = loss + aux
        state.optimizer.zero_grad(set_to_none=True)
        (term + aux).backward()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        ring = self._group_ring
        if ring is not None:  # the global gradient is the sum of the ranks'
            _all_reduce_sum(grads, ring.group)
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
        ProcessGroupRing)."""
        batch = self._to_device(self.shard_batch(batch))
        return state.model(*_model_inputs(batch))

    @torch.no_grad()
    def evaluate(self, state: TrainState, data_iter, num_batches: int) -> Dict[str, float]:
        """Mean loss over ``num_batches`` held-out batches (no state update);
        the losses add up on the device and are read once at the end."""
        if num_batches < 1:
            raise ValueError("evaluate needs num_batches >= 1")
        total = None
        for _ in range(num_batches):
            batch = self._to_device(self.shard_batch(next(data_iter)))
            loss = self._losses(state.model(*_model_inputs(batch)), batch)[1]
            total = loss if total is None else total + loss
        return {"loss": float(total) / num_batches}

    def fit(
        self,
        state: TrainState,
        data_iter,
        num_steps: int,
        reporter=None,
        report_every: int = 10,
        metric_key: str = "loss",
        metric_sign: float = 1.0,
        metrics_window: int = 2,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Host loop: step, and at step boundaries broadcast
        ``metric_sign * metrics[metric_key]`` to a duck-typed
        ``reporter.broadcast(value, step=)``.

        Lagged metrics drain: a broadcast reads the metrics of the step that
        just left a ``metrics_window``-deep window, so the host reads a value
        the card finished long ago and does not stall the queue of work;
        ``metrics_window=0`` broadcasts the current step's value. Returns the
        final step's metrics as floats plus ``steps_per_sec`` (wall time
        measured after the final read, which waits for the card)."""
        step0 = state.step
        metrics: Dict[str, torch.Tensor] = {}
        window = max(0, int(metrics_window))
        pending: deque = deque()  # (loop index, in-flight metrics)
        ready = None  # newest entry aged out of the window
        last_bcast = -1
        t0 = time.perf_counter()
        for i in range(num_steps):
            state, metrics = self.step(state, self.shard_batch(next(data_iter)))
            pending.append((i, metrics))
            while len(pending) > max(1, window):
                ready = pending.popleft()
            if reporter is not None and (i + 1) % report_every == 0:
                src = pending[-1] if window == 0 else ready
                if (src is None or src[0] <= last_bcast) and i == num_steps - 1:
                    src = pending[0]  # final boundary: window not primed
                if src is not None and src[0] > last_bcast:
                    j, lagged = src
                    last_bcast = j
                    value = metric_sign * float(lagged[metric_key])
                    reporter.broadcast(value, step=step0 + j + 1)
        out = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        if num_steps > 0 and wall > 0:
            out["steps_per_sec"] = num_steps / wall
        return state, out


def _require_ring(spec: ShardingSpec) -> None:
    if spec.sp < 2:
        raise ValueError(
            f"a TrainContext runs sequence parallelism and needs sp > 1, got "
            f"sp={spec.sp}; train on one device with Trainer directly"
        )


@dataclasses.dataclass
class TrainContext:
    """What a sequence-parallel ``train_fn`` is handed: the spec, the ring
    its model attends over, and the device. Counterpart of the JAX
    package's ``TrainContext`` for ``ShardingSpec(sp=n)``; every other axis
    raises (ROADMAP queue 1 item 7).

    ``create`` is the multi-card path, one process per rank over an
    initialised ``torch.distributed`` group; ``local`` runs every rank of
    the ring in this process (one card, or the CPU in tests). The model
    names the ring itself:
    ``DecoderConfig(attention_fn=make_ring_attention(ctx.ring))``."""

    spec: ShardingSpec
    ring: Any
    device: torch.device

    @classmethod
    def create(cls, spec_or_preset: Union[ShardingSpec, str] = "sp", *, device=None) -> "TrainContext":
        """A :class:`ProcessGroupRing` over the default process group, whose
        size must equal ``spec.num_devices``. The device is
        ``cuda:LOCAL_RANK`` unless one is given (``device="cpu"`` for gloo)."""
        import os

        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "TrainContext.create needs an initialised torch.distributed process "
                "group; use TrainContext.local for a ring inside one process"
            )
        size = dist.get_world_size()
        spec = spec_or_preset
        if isinstance(spec, str):
            spec = ShardingSpec.preset(spec, size)
        _require_ring(spec)
        if spec.num_devices != size:
            raise ValueError(f"{spec} needs {spec.num_devices} ranks, the process group has {size}")
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        return cls(spec, ProcessGroupRing(), resolve_device(device))

    @classmethod
    def local(cls, spec: ShardingSpec, device=None) -> "TrainContext":
        """A :class:`LocalRing` of ``spec.sp`` ranks in this process."""
        _require_ring(spec)
        return cls(spec, LocalRing(spec.sp), resolve_device(device))

    @property
    def process_index(self) -> int:
        return self.ring.rank if isinstance(self.ring, ProcessGroupRing) else 0

    @property
    def num_processes(self) -> int:
        return self.ring.size if isinstance(self.ring, ProcessGroupRing) else 1

    def trainer(self, model: nn.Module, optimizer, loss_fn: Callable = lm_loss_fn) -> Trainer:
        return Trainer(model, optimizer, device=self.device, loss_fn=loss_fn, ring=self.ring)

    def shard_batch(self, global_batch: Batch) -> Batch:
        """Every rank passes the same global batch and gets its own chunk
        (:func:`shard_sequence`); with a LocalRing, the batch itself."""
        return _shard_for(self.ring, global_batch)
