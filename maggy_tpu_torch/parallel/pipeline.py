"""Pipeline parallelism over the ``stage`` mesh axis: GPipe and 1F1B.

Counterpart of :mod:`maggy_tpu.parallel.pipeline`, with its four public
names and contracts. JAX runs every stage inside one ``shard_map`` and
hands activations on with ``ppermute``; here each rank is one process that
runs its own stage, and the hand-offs are point-to-point sends over the
mesh's ``stage`` group (``batch_isend_irecv``: gloo on the CPU, NCCL on the
card). Every schedule is a clock that all stages keep in step: at each tick
a stage does at most one operation, then every send and receive of that
tick is posted at once and waited for, so a stage knows from the clock
alone which microbatch arrives when.

* :func:`pipeline_apply` — GPipe: with S stages and M microbatches the loop
  runs M + S - 1 ticks; at tick t stage s runs microbatch t - s. It is
  differentiable: its backward runs the same clock in reverse, each stage
  re-running its forward on the input it kept (O(M) stage inputs a stage,
  as JAX's autodiff keeps O(ticks) residuals).
* :func:`pipeline_grads_1f1b` — one training step in the one-forward-
  one-backward order (PipeDream-flush), on JAX's closed-form clock: the
  forward of microbatch m at stage s runs at tick s + m in the warm-up
  (m <= S-1-s) and at 2m + s after it, its backward at 2S-1-s+2m, T = 2M +
  2S - 2 ticks in all. Each stage keeps its in-flight stage *inputs* only
  (never more than S + 1) and re-runs its forward inside the backward, so
  activation memory is O(S) stage inputs; the last stage, whose forward
  output has no consumer, runs only the backward tick. Gradient hand-offs
  arrive exactly one tick before their consumer.
* :func:`pipeline_forward_loss` — the forward-only GPipe sweep, the
  evaluation counterpart of the 1F1B step.
* :func:`stack_stage_params` — layer-stacked ``[L, ...]`` tensors as
  ``[n_stages, L // n_stages, ...]`` (a stage takes its row).

Where JAX's ``stage_params`` carries a leading ``[n_stages]`` axis sharded
over ``stage``, here it is this rank's stage alone: a pytree of tensors or
an ``nn.Module`` (whose parameters receive the gradients in ``.grad``).
The microbatches are this rank's rows (its share of the global batch over
``data`` and ``fsdp``); ``mesh=None`` is one stage on one rank.

Loss averaging is JAX's: each microbatch's ``loss_fn`` is taken with
cotangent 1 on the last stage, and the summed losses and gradients are
reduced over the batch ranks (``data``, ``fsdp``) and divided by
``data x fsdp x M``. Any failure to reach a peer raises; nothing falls back
to running the stages in one process.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from maggy_tpu_torch.parallel.sharding import BATCH_AXES
from maggy_tpu_torch.parallel.spec import AXIS_STAGE

# tags of the two hand-offs between neighbouring stages (gloo matches a
# receive by sender and tag; NCCL ignores tags)
ACT_TAG, GRAD_TAG = 0, 1
# default process groups whose communicator the schedules have brought up,
# by id (each held, so that a later group cannot take a dead one's id)
_warmed: dict = {}


class _Topology:
    """This rank's place in the pipeline: the stage count ``S``, its stage
    ``s``, its neighbours' global ranks, and the batch groups
    (``slice``, ``data``, ``fsdp`` of extent > 1) gradients and losses are
    summed over."""

    def __init__(self, mesh, axis_name: str):
        self.mesh = mesh
        self.S, self.s, self.prev, self.next = 1, 0, None, None
        self.group, self.batch_groups, self.dpf = None, [], 1
        if mesh is None:
            return
        from maggy_tpu_torch.parallel.mesh import mesh_shape

        shape = mesh_shape(mesh)
        self.S = shape.get(axis_name, 1)
        self.batch_groups = [mesh.get_group(a) for a in BATCH_AXES if shape.get(a, 1) > 1]
        self.dpf = math.prod(shape.get(a, 1) for a in BATCH_AXES)
        if self.S > 1:
            import torch.distributed as dist

            self.group = mesh.get_group(axis_name)
            self.s = mesh.get_local_rank(axis_name)
            if self.s > 0:
                self.prev = dist.get_global_rank(self.group, self.s - 1)
            if self.s < self.S - 1:
                self.next = dist.get_global_rank(self.group, self.s + 1)

    @property
    def last(self) -> bool:
        return self.s == self.S - 1

    def warm(self, device) -> None:
        """Bring the default group's communicator up with one collective that
        every rank reaches (NCCL builds it lazily, and a first point-to-point
        call that not every rank joins may hang)."""
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        group = distributed_c10d._get_default_group()
        if id(group) not in _warmed:
            dist.all_reduce(torch.zeros(1, device=device))
            _warmed[id(group)] = group

    def sum_over_batch(self, tensors) -> None:
        """Sum ``tensors`` in place over the batch ranks (a DTensor's local
        shard, which its peers over ``data`` and ``fsdp`` hold alike)."""
        if not self.batch_groups:
            return
        from maggy_tpu_torch.train.trainer import _all_reduce_sum, _local

        local = [_local(t) for t in tensors]
        for group in self.batch_groups:
            _all_reduce_sum(local, group)

    def reduce_scalars(self, values: torch.Tensor, over_stages: bool) -> torch.Tensor:
        """``values`` summed over the stages (when asked) and the batch ranks:
        JAX's ``reduce_scalar`` before its division."""
        import torch.distributed as dist

        values = values.clone()
        if over_stages and self.group is not None:
            dist.all_reduce(values, group=self.group)
        for group in self.batch_groups:
            dist.all_reduce(values, group=group)
        return values


def _exchange(sends, recvs) -> None:
    """Post this tick's sends and receives (``(tensor, peer, tag)``) at once
    and wait for all of them."""
    if not sends and not recvs:
        return
    import torch.distributed as dist

    ops = [dist.P2POp(dist.isend, t, peer, tag=tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, tag=tag) for t, peer, tag in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


class _Params:
    """A stage's parameters as the schedules use them: ``call`` is what the
    stage functions receive, ``leaves`` the tensors gradients go to."""

    def __init__(self, stage_params):
        self.module = isinstance(stage_params, torch.nn.Module)
        if self.module:
            self.call = stage_params
            self.leaves = [p for p in stage_params.parameters() if p.requires_grad]
        else:
            flat, self.spec = pytree.tree_flatten(stage_params)
            self.leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in flat]
            self.call = pytree.tree_unflatten(self.leaves, self.spec)

    def scale_and_sum(self, top: _Topology, factor: float) -> None:
        grads = [p.grad for p in self.leaves if p.grad is not None]
        with torch.no_grad():
            for g in grads:
                g.mul_(factor)
            top.sum_over_batch(grads)

    def grads(self):
        if self.module:
            return {name: p.grad for name, p in self.call.named_parameters() if p.requires_grad}
        return pytree.tree_unflatten(
            [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.leaves], self.spec)


def _stage_runner(stage_fn, stage_takes_raw: bool, stage_has_aux: bool):
    """``run(params, x, raw) -> (y, aux)`` for any of the three stage
    function contracts."""
    def run(p, x, raw):
        out = stage_fn(p, x, raw) if stage_takes_raw else stage_fn(p, x)
        if stage_has_aux:
            return out
        return out, None
    return run


def _index(tree, m: int):
    return pytree.tree_map(lambda a: a[m], tree)


def _backward(outputs, cotangents, inputs) -> None:
    """Accumulate the gradients of ``outputs`` (with their cotangents) into
    ``inputs``' ``.grad``; outputs that do not require grad are dropped."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o is not None and o.requires_grad]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs], inputs=inputs)


# ------------------------------------------------------------------ GPipe


class _GPipe(torch.autograd.Function):
    """The GPipe sweep as one autograd node: the last stage's outputs
    ``[M, ...]`` (zeros elsewhere); its backward runs the clock in reverse
    and returns each parameter's gradient summed over the batch ranks."""

    @staticmethod
    def forward(ctx, info, mbs, *leaves):
        top, stage_fn, spec = info
        S, s, M = top.S, top.s, mbs.shape[0]
        params = pytree.tree_unflatten(list(leaves), spec)
        inputs, outs, pending = [None] * M, [None] * M, {}
        for t in range(M + S - 1):
            sends, recvs = [], []
            m = t - s
            if 0 <= m < M:
                x = mbs[m] if s == 0 else pending.pop(m)
                inputs[m] = x
                y = stage_fn(params, x)
                if top.last:
                    outs[m] = y
                else:
                    sends.append((y.contiguous(), top.next, ACT_TAG))
            if s > 0 and 0 <= t - (s - 1) < M:
                buf = torch.empty(mbs.shape[1:], dtype=mbs.dtype, device=mbs.device)
                pending[t - (s - 1)] = buf
                recvs.append((buf, top.prev, ACT_TAG))
            _exchange(sends, recvs)
        ctx.info, ctx.inputs = info, inputs
        ctx.save_for_backward(*leaves)
        return torch.stack(outs) if top.last else torch.zeros_like(mbs)

    @staticmethod
    def backward(ctx, g_out):
        top, stage_fn, spec = ctx.info
        S, s, M = top.S, top.s, len(ctx.inputs)
        leaves = [p.detach().requires_grad_(need) for p, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        params = pytree.tree_unflatten(leaves, spec)
        want_dx = s > 0 or ctx.needs_input_grad[1]
        dmbs = torch.zeros_like(g_out) if ctx.needs_input_grad[1] else None
        g_recv = {}
        for t in range(M + S - 1):
            sends, recvs = [], []
            k = t - (S - 1 - s)
            if 0 <= k < M:
                m = M - 1 - k
                g = g_out[m] if top.last else g_recv.pop(m)
                x = ctx.inputs[m].detach().requires_grad_(want_dx)
                with torch.enable_grad():
                    y = stage_fn(params, x)
                _backward([y], [g], [p for p in leaves if p.requires_grad] + ([x] if want_dx else []))
                if s > 0:
                    sends.append((x.grad.contiguous(), top.prev, GRAD_TAG))
                elif dmbs is not None:
                    dmbs[m] = x.grad
            if not top.last and 0 <= t - (S - 2 - s) < M:
                buf = torch.empty_like(g_out[0])
                g_recv[M - 1 - (t - (S - 2 - s))] = buf
                recvs.append((buf, top.next, GRAD_TAG))
            _exchange(sends, recvs)
        grads = [p.grad if p.requires_grad else None for p in leaves]
        top.sum_over_batch([g for g in grads if g is not None])
        return (None, dmbs, *grads)


class _StageSum(torch.autograd.Function):
    """The last stage's outputs on every stage (an all-reduce over the stage
    group); the gradient passes through as it is, since each stage's copy
    of the loss is the same."""

    @staticmethod
    def forward(ctx, local, group):
        import torch.distributed as dist

        out = local.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _StageScatter(torch.autograd.Function):
    """Each stage's ``M / S`` microbatches of the outputs (a reduce-scatter
    over the stage group); the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, local, group, n):
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.overlap import _reduce_scatter

        ctx.group, ctx.n = group, n
        out = torch.empty((local.shape[0] // n,) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
        _reduce_scatter(dist)(out, local.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.overlap import all_gather_flat

        full = torch.empty((g.shape[0] * ctx.n,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
        all_gather_flat(dist)(full, g.contiguous(), group=ctx.group)
        return full, None, None


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    *,
    mesh=None,
    axis_name: str = AXIS_STAGE,
    out_mode: str = "replicated",
):
    """Run a layer pipeline over the mesh's ``stage`` axis (GPipe).

    :param stage_fn: ``fn(params_of_this_stage, x) -> y``, keeping the
        activation's shape and dtype.
    :param stage_params: this rank's stage: a pytree of tensors (a row of
        :func:`stack_stage_params`'s result). Differentiable: gradients
        reach its leaves, summed over the batch ranks.
    :param microbatches: ``[n_micro, mb, ...]`` activations of this rank's
        rows; every stage passes them (only stage 0 reads them).
    :param out_mode: ``"replicated"`` all-reduces the output buffer so every
        stage holds it; ``"scatter"`` reduce-scatters the ``n_micro`` axis
        over the stages (``n_micro % n_stages == 0``).
    :returns: ``[n_micro, mb, ...]`` outputs of the last stage
        (``[n_micro / n_stages, mb, ...]`` on each stage for ``"scatter"``).
    """
    if out_mode not in ("replicated", "scatter"):
        raise ValueError(f"out_mode must be 'replicated' or 'scatter', got {out_mode!r}")
    top = _Topology(mesh, axis_name)
    if top.S == 1:
        return torch.stack([stage_fn(stage_params, x) for x in microbatches])
    n_micro = microbatches.shape[0]
    if n_micro < top.S:
        raise ValueError(
            f"Need at least as many microbatches ({n_micro}) as stages ({top.S}) to fill the pipeline."
        )
    if out_mode == "scatter" and n_micro % top.S:
        raise ValueError(f"out_mode='scatter' needs n_micro ({n_micro}) divisible by stages ({top.S})")
    top.warm(microbatches.device)
    flat, spec = pytree.tree_flatten(stage_params)
    local = _GPipe.apply((top, stage_fn, spec), microbatches, *flat)
    if out_mode == "scatter":
        return _StageScatter.apply(local, top.group, top.S)
    return _StageSum.apply(local, top.group)


# ------------------------------------------------------------------ 1F1B


def _fwd_micro(t: int, s: int, S: int, M: int):
    """The microbatch (if any) stage ``s`` forwards at tick ``t``."""
    warm = t - s
    if 0 <= warm <= S - 1 - s and warm < M:
        return warm
    if warm >= 0 and warm % 2 == 0 and S - 1 - s < warm // 2 < M:
        return warm // 2
    return None


def _bwd_micro(t: int, s: int, S: int, M: int):
    """The microbatch (if any) stage ``s`` runs the backward of at tick ``t``."""
    tb = t - (2 * S - 1 - s)
    if tb >= 0 and tb % 2 == 0 and tb // 2 < M:
        return tb // 2
    return None


def _activation(top: _Topology, first_fn, params, raw0, activation):
    """``(shape, dtype)`` of the hand-offs: given, or the microbatches' own
    without a ``first_fn``, or what ``first_fn`` makes of a raw microbatch
    on stage 0, sent to the other stages."""
    if activation is not None:
        return tuple(activation[0]), activation[1]
    if first_fn is None:
        return tuple(raw0.shape), raw0.dtype
    import torch.distributed as dist

    box = [None]
    if top.s == 0:
        with torch.no_grad():
            x = first_fn(params, raw0)
        box = [(tuple(x.shape), x.dtype)]
    dist.broadcast_object_list(box, src=dist.get_global_rank(top.group, 0), group=top.group)
    return box[0]


def pipeline_grads_1f1b(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    targets,
    *,
    mesh=None,
    axis_name: str = AXIS_STAGE,
    first_fn: Optional[Callable] = None,
    stage_takes_raw: bool = False,
    stage_has_aux: bool = False,
    activation=None,
    stats: Optional[Dict[str, Any]] = None,
):
    """One training step on the 1F1B schedule: returns ``(loss, grads)``.

    :param stage_fn: ``fn(params, x) -> y`` keeping shape and dtype, or
        ``fn(params, x, raw)`` with ``stage_takes_raw=True``: every stage
        also gets the current microbatch's raw rows, so side inputs every
        layer needs (segment ids, positions) never ride the hand-offs.
    :param loss_fn: ``fn(params, y_final, target) -> scalar``, the loss of
        one microbatch, on the last stage only; taking the stage's
        parameters lets the head (final norm, ``lm_head``) live inside it.
    :param stage_params: this rank's stage, a pytree of tensors or an
        ``nn.Module`` (its parameters' ``.grad`` receive the gradients, added
        to what they hold).
    :param microbatches: ``[n_micro, mb, ...]`` (this rank's rows);
        ``targets`` any pytree of ``[n_micro, ...]`` leaves ``loss_fn`` reads.
    :param first_fn: ``fn(params, raw) -> x``, stage 0's ingest of a raw
        microbatch (the embedding lookup), differentiated with its stage.
    :param stage_has_aux: the stage function returns ``(y, aux_scalar)``;
        each stage's aux joins the objective at its own backward tick, and
        the return gains a third element, the summed aux (a microbatch mean).
    :param activation: ``(shape, dtype)`` of one hand-off; without it, the
        microbatches' own, or (with ``first_fn``) what stage 0's
        ``first_fn`` makes, sent to the other stages once per call.
    :param stats: filled with ``ticks``, ``forward_ops``, ``backward_ops``
        and ``max_inputs_held`` (the most stage inputs this stage held at
        once: at most S + 1).
    :returns: ``loss``, the mean over every microbatch and batch rank (the
        same on every rank), and ``grads``, shaped as ``stage_params``
        (``{name: grad}`` for a module), summed over the batch ranks and
        divided as the loss is.
    """
    if first_fn is None:
        first_fn = lambda params, raw: raw  # noqa: E731 - identity ingest
    run_stage = _stage_runner(stage_fn, stage_takes_raw, stage_has_aux)
    top = _Topology(mesh, axis_name)
    S, s, M = top.S, top.s, microbatches.shape[0]
    params = _Params(stage_params)
    if S > 1 and M < S:
        raise ValueError(f"Need at least as many microbatches ({M}) as stages ({S}).")
    loss_acc = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    counts = dict(ticks=0, forward_ops=0, backward_ops=0, max_inputs_held=0)

    def last_backward(raw, x_in, tgt):
        """The last stage's op: forward from the kept input, the loss,
        and the backward with cotangent 1 on the loss and the aux."""
        nonlocal loss_acc, aux_acc
        with torch.enable_grad():
            x = first_fn(params.call, raw) if s == 0 else x_in
            y, aux = run_stage(params.call, x, raw)
            lval = loss_fn(params.call, y, tgt)
        one = torch.ones((), dtype=lval.dtype, device=lval.device)
        _backward([lval, aux], [one, None if aux is None else torch.ones_like(aux)],
                  params.leaves + ([x_in] if x_in is not None else []))
        loss_acc = loss_acc + lval.detach().float()
        if aux is not None:
            aux_acc = aux_acc + aux.detach().float()

    if S == 1:
        for m in range(M):
            last_backward(microbatches[m], None, _index(targets, m))
        counts.update(ticks=M, forward_ops=M, backward_ops=M)
    else:
        top.warm(microbatches.device)
        shape, dtype = _activation(top, first_fn, params.call, microbatches[0], activation)
        held: Dict[int, torch.Tensor] = {}  # in-flight stage inputs, by microbatch
        g_recv: Dict[int, torch.Tensor] = {}
        T = 2 * M + 2 * S - 2
        for t in range(T):
            sends, recvs = [], []
            m_f = _fwd_micro(t, s, S, M)
            if m_f is not None and not top.last:
                raw = microbatches[m_f]
                with torch.no_grad():
                    x = first_fn(params.call, raw) if s == 0 else held[m_f]
                    y, _ = run_stage(params.call, x, raw)
                sends.append((y.contiguous(), top.next, ACT_TAG))
                counts["forward_ops"] += 1
            m_b = _bwd_micro(t, s, S, M)
            if m_b is not None:
                raw = microbatches[m_b]
                x_in = held.pop(m_b).requires_grad_(True) if s > 0 else None
                if top.last:
                    last_backward(raw, x_in, _index(targets, m_b))
                else:
                    with torch.enable_grad():
                        x = first_fn(params.call, raw) if s == 0 else x_in
                        y, aux = run_stage(params.call, x, raw)
                    _backward([y, aux], [g_recv.pop(m_b), None if aux is None else torch.ones_like(aux)],
                              params.leaves + ([x_in] if x_in is not None else []))
                    if aux is not None:
                        aux_acc = aux_acc + aux.detach().float()
                if s > 0:
                    sends.append((x_in.grad.contiguous(), top.prev, GRAD_TAG))
                counts["backward_ops"] += 1
            if s > 0:
                m_a = _fwd_micro(t, s - 1, S, M)
                if m_a is not None:
                    held[m_a] = torch.empty(shape, dtype=dtype, device=microbatches.device)
                    recvs.append((held[m_a], top.prev, ACT_TAG))
            if not top.last:
                m_g = _bwd_micro(t, s + 1, S, M)
                if m_g is not None:
                    g_recv[m_g] = torch.empty(shape, dtype=dtype, device=microbatches.device)
                    recvs.append((g_recv[m_g], top.next, GRAD_TAG))
            _exchange(sends, recvs)
            counts["max_inputs_held"] = max(counts["max_inputs_held"], len(held) + (m_b is not None and s > 0))
        counts["ticks"] = T
    if stats is not None:
        stats.update(counts)
    denom = top.dpf * M
    params.scale_and_sum(top, 1.0 / denom)
    loss, aux = top.reduce_scalars(torch.stack([loss_acc, aux_acc]), over_stages=S > 1) / denom
    if stage_has_aux:
        return loss, params.grads(), aux
    return loss, params.grads()


def pipeline_forward_loss(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    targets,
    *,
    mesh=None,
    axis_name: str = AXIS_STAGE,
    first_fn: Optional[Callable] = None,
    stage_takes_raw: bool = False,
    stage_has_aux: bool = False,
    activation=None,
):
    """The forward-only GPipe sweep: ``(loss, aux)`` microbatch means, the
    evaluation counterpart of :func:`pipeline_grads_1f1b` with its
    contracts. Each stage holds its parameters and one microbatch's
    activation (never the whole model): M + S - 1 ticks, no gradients."""
    if first_fn is None:
        first_fn = lambda params, raw: raw  # noqa: E731 - identity ingest
    run_stage = _stage_runner(stage_fn, stage_takes_raw, stage_has_aux)
    top = _Topology(mesh, axis_name)
    S, s, M = top.S, top.s, microbatches.shape[0]
    loss_acc = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    with torch.no_grad():
        if S == 1:
            for m in range(M):
                raw = microbatches[m]
                y, aux = run_stage(stage_params, first_fn(stage_params, raw), raw)
                loss_acc += loss_fn(stage_params, y, _index(targets, m)).float()
                if aux is not None:
                    aux_acc += aux.float()
        else:
            top.warm(microbatches.device)
            shape, dtype = _activation(top, first_fn, stage_params, microbatches[0], activation)
            pending: Dict[int, torch.Tensor] = {}
            for t in range(M + S - 1):
                sends, recvs = [], []
                m = t - s
                if 0 <= m < M:
                    raw = microbatches[m]
                    x = first_fn(stage_params, raw) if s == 0 else pending.pop(m)
                    y, aux = run_stage(stage_params, x, raw)
                    if aux is not None:
                        aux_acc += aux.float()
                    if top.last:
                        loss_acc += loss_fn(stage_params, y, _index(targets, m)).float()
                    else:
                        sends.append((y.contiguous(), top.next, ACT_TAG))
                if s > 0 and 0 <= t - (s - 1) < M:
                    pending[t - (s - 1)] = torch.empty(shape, dtype=dtype, device=microbatches.device)
                    recvs.append((pending[t - (s - 1)], top.prev, ACT_TAG))
                _exchange(sends, recvs)
    loss, aux = top.reduce_scalars(torch.stack([loss_acc, aux_acc]), over_stages=S > 1) / (top.dpf * M)
    return loss, aux


def stack_stage_params(per_layer_params, n_stages: int):
    """Reshape layer-stacked tensors ``[L, ...]`` into ``[n_stages,
    L // n_stages, ...]``: row ``s`` is stage ``s``'s layers."""

    def reshape(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])

    return pytree.tree_map(reshape, per_layer_params)
