"""Single-device trainer: dense AdamW steps on one card.

Counterpart of the single-device dense path of
:mod:`maggy_tpu.train.trainer`: the LM and classification losses, a
``TrainState``, and a ``Trainer`` with ``make_state``, ``step``,
``eval_logits``, ``evaluate`` and a minimal ``fit``. The mesh, pipeline,
overlap/ZeRO, autopilot, checkpoint, resume and prefetch parts of the JAX
trainer belong to later slices of the port.

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

import torch
from torch import nn

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
    raises when there is none; pass ``device="cpu"`` to run on the CPU."""

    model: nn.Module
    optimizer: Callable[..., torch.optim.Optimizer]
    device: Any = None
    loss_fn: Callable = lm_loss_fn

    def __post_init__(self):
        self.device = resolve_device(self.device)

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
        return TrainState(model, self.optimizer(model.parameters()), 0)

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    # ------------------------------------------------------------------ steps

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One AdamW step; metrics as in the JAX dense step."""
        batch = self._to_device(batch)
        logits = state.model(*_model_inputs(batch))
        loss = self.loss_fn(logits, batch)
        del logits
        # the dense decoder sows no auxiliary losses (MoE router terms)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        total = loss + aux
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
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
        """Full logits for one batch."""
        batch = self._to_device(batch)
        return state.model(*_model_inputs(batch))

    @torch.no_grad()
    def evaluate(self, state: TrainState, data_iter, num_batches: int) -> Dict[str, float]:
        """Mean loss over ``num_batches`` held-out batches (no state update);
        the losses add up on the device and are read once at the end."""
        if num_batches < 1:
            raise ValueError("evaluate needs num_batches >= 1")
        total = None
        for _ in range(num_batches):
            batch = self._to_device(next(data_iter))
            loss = self.loss_fn(state.model(*_model_inputs(batch)), batch)
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
            state, metrics = self.step(state, next(data_iter))
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
