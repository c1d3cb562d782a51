"""Bucketed gradient reduction and ZeRO-1 optimizer-state sharding.

The port's copy of :mod:`maggy_tpu.parallel.overlap`, with the same plan:

* **Buckets.** The parameters are cut into size-bounded buckets in
  *reverse* flatten order (the order backward produces their gradients,
  last layers first); consecutive leaves of different dtype never share a
  bucket, and a bucket is padded to a multiple of ``pad_to`` (the ZeRO
  shard count). The leaf order is the JAX tree-flatten order of the same
  model (:func:`jax_leaf_order`: flax's sorted keys, which
  :func:`maggy_tpu_torch.convert.decoder_params_from_flax` maps one to one
  for a per-layer tree), so a bucket holds the same parameters as JAX's.
* **Bucketed reduction** (``mode="bucket"``, :class:`BucketedGrads`): each
  bucket's gradients are copied into one flat vector as backward
  accumulates them (``register_post_accumulate_grad_hook``) and the
  bucket is all-reduced over ``data`` asynchronously as soon as it is
  full, while the rest of backward runs. Buckets are launched in plan
  order on every rank, so the collectives line up.
* **ZeRO-1** (``mode="zero"``, :class:`ZeroShards`): the parameters are
  views into one flat padded buffer per bucket; each bucket's gradient is
  reduce-scattered, and the optimizer holds one leaf per bucket shard
  (``1/dz`` of the bucket, a view into the flat buffer), so AdamW's
  foreach kernels update only this rank's shard; an all-gather of each
  shard into its buffer then rebuilds every parameter in place. The
  optimizer state per rank shrinks to about ``1/dz``. Its checkpoint layout
  is JAX's: one flat padded vector per bucket and moment.

JAX's ``latency_hiding_flags`` sets XLA scheduler flags and has no
PyTorch meaning: here the overlap comes from the asynchronous per-bucket
collectives themselves (ROADMAP "Deliberate divergences").

Like JAX's, the ZeRO step hands the optimizer flat shards, so an
optimizer whose update couples parameters across the tree computes those
couplings per shard; AdamW is exact.
"""

from __future__ import annotations

import dataclasses
import math
import re
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Bucket",
    "BucketPlan",
    "BucketedGrads",
    "OverlapLayout",
    "ZeroShards",
    "jax_leaf_order",
    "plan_buckets",
    "flatten_buckets",
    "unflatten_buckets",
    "flatten_opt_state",
    "unflatten_opt_state",
    "reflatten_opt_state",
    "opt_state_bytes_per_device",
    "measure_step_times",
    "record_overlap_gauges",
]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One reduction unit: a contiguous (in reverse flatten order) run of
    same-dtype leaves, flattened into a single padded vector."""

    name: str  # "b000" ...: zero-padded, so sorted names are plan order
    indices: Tuple[int, ...]  # positions in the flatten-order leaf list
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]  # element counts per leaf, parallel to indices
    dtype: str
    size: int  # sum(sizes), before padding
    padded_size: int  # size rounded up to a multiple of the plan's pad_to


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The bucketing of one list of leaves: shape metadata only."""

    buckets: Tuple[Bucket, ...]
    n_leaves: int
    pad_to: int  # the ZeRO shard count every bucket divides into

    @property
    def padded_sizes(self) -> frozenset:
        return frozenset(b.padded_size for b in self.buckets)


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def jax_leaf_order(names: Sequence[str]) -> List[str]:
    """``names`` (a model's ``named_parameters()`` keys) in the JAX
    package's tree-flatten order of the same parameters: each name as the
    flax path (``layers.3.`` under ``layers_3/layer/``, ``weight`` as
    ``kernel``), sorted as flax sorts a dict's keys, level by level."""

    def path(name: str) -> Tuple[str, ...]:
        name = re.sub(r"^layers\.(\d+)\.", r"layers_\1.layer.", name)
        parts = name.split(".")
        return tuple("kernel" if p == "weight" else p for p in parts)

    return sorted(names, key=path)


def plan_buckets(params: Any, bucket_mb: Optional[float], pad_to: int = 1) -> BucketPlan:
    """Partition ``params``' leaves (a sequence of tensors, or a dict whose
    insertion order is the flatten order) into size-bounded reverse-order
    buckets.

    ``bucket_mb`` bounds each bucket's payload in MiB (None or inf: one
    bucket per run of one dtype); a single leaf above the bound still gets
    its own bucket. Leaves are walked in REVERSE order so bucket 0 holds
    the parameters whose gradients backward produces first; consecutive
    leaves of different dtype never share a bucket. ``pad_to`` rounds
    every bucket up so a reduce-scatter over that many shards divides it
    evenly."""
    leaves = _leaves(params)
    if not leaves:
        raise ValueError("plan_buckets: empty param tree")
    if pad_to < 1:
        raise ValueError(f"plan_buckets: pad_to must be >= 1, got {pad_to}")
    cap = (
        float("inf")
        if bucket_mb is None or not math.isfinite(float(bucket_mb))
        else float(bucket_mb) * 2**20
    )
    buckets: List[Bucket] = []
    cur: list = []
    cur_bytes = 0.0
    cur_dtype = None

    def close():
        if not cur:
            return
        sizes = tuple(size for _, _, size in cur)
        total = sum(sizes)
        buckets.append(Bucket(
            name=f"b{len(buckets):03d}",
            indices=tuple(i for i, _, _ in cur),
            shapes=tuple(shape for _, shape, _ in cur),
            sizes=sizes,
            dtype=cur_dtype,
            size=total,
            padded_size=-(-total // pad_to) * pad_to,
        ))
        cur.clear()

    for i in range(len(leaves) - 1, -1, -1):
        leaf = leaves[i]
        shape = tuple(leaf.shape)
        size = math.prod(shape) if shape else 1
        dtype = _dtype_name(leaf.dtype)
        nbytes = size * leaf.element_size()
        if cur and (dtype != cur_dtype or cur_bytes + nbytes > cap):
            close()
            cur_bytes = 0.0
        cur_dtype = dtype
        cur_bytes += nbytes
        cur.append((i, shape, size))
    close()
    return BucketPlan(buckets=tuple(buckets), n_leaves=len(leaves), pad_to=int(pad_to))


def flatten_buckets(tree: Any, plan: BucketPlan) -> Dict[str, torch.Tensor]:
    """``{bucket name: flat padded vector}`` for leaves matching the plan
    (parameters, gradients or optimizer moments), in plan order."""
    leaves = _leaves(tree)
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"flatten_buckets: tree has {len(leaves)} leaves, plan expects {plan.n_leaves}")
    out = {}
    for b in plan.buckets:
        first = leaves[b.indices[0]]
        vec = torch.zeros(b.padded_size, dtype=first.dtype, device=first.device)
        off = 0
        for i, size in zip(b.indices, b.sizes):
            vec[off:off + size].copy_(leaves[i].reshape(-1))
            off += size
        out[b.name] = vec
    return out


def unflatten_buckets(flats: Dict[str, torch.Tensor], plan: BucketPlan, template: Any):
    """Inverse of :func:`flatten_buckets`: the leaves (views into the flat
    vectors, padding dropped), as a list, or as a dict with ``template``'s
    keys when it is one."""
    leaves: list = [None] * plan.n_leaves
    for b in plan.buckets:
        vec = flats[b.name]
        off = 0
        for i, shape, size in zip(b.indices, b.shapes, b.sizes):
            leaves[i] = vec[off:off + size].view(shape)
            off += size
    if isinstance(template, dict):
        return dict(zip(template, leaves))
    return leaves


# ------------------------------------------------------- optimizer states
#
# A PyTorch optimizer's state_dict: {"state": {index: {key: value}},
# "param_groups": [{..., "params": [index, ...]}]}. Dense: one index per
# leaf of the plan (leaf order); flat (ZeRO-1): one index per bucket, each
# moment the bucket's flat padded vector. A value shaped like its leaf is
# a mirror of it (AdamW's exp_avg, exp_avg_sq) and is flattened; anything
# else (AdamW's step count) passes through.


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def _groups(param_groups, n: int):
    if len(param_groups) != 1:
        raise ValueError(f"a ZeRO-1 layout holds one param group, got {len(param_groups)}")
    return [{**param_groups[0], "params": list(range(n))}]


def flatten_opt_state(opt_state: Dict[str, Any], plan: BucketPlan, params_template: Any) -> Dict[str, Any]:
    """A dense optimizer ``state_dict`` (indexed by leaf) as the flat ZeRO
    layout: each bucket's per-leaf mirrors concatenated and padded, the
    other values taken from the bucket's first leaf."""
    shapes = [_shape_of(p) for p in _leaves(params_template)]
    if len(shapes) != plan.n_leaves:
        raise ValueError(f"flatten_opt_state: template has {len(shapes)} leaves, plan expects {plan.n_leaves}")
    dense = opt_state["state"]
    state = {}
    for j, b in enumerate(plan.buckets):
        per_leaf = [dense.get(i) for i in b.indices]
        if any(v is None for v in per_leaf):
            continue  # an optimizer that has not stepped yet holds no state
        out = {}
        for key, first in per_leaf[0].items():
            if isinstance(first, torch.Tensor) and tuple(first.shape) == shapes[b.indices[0]]:
                out[key] = flatten_buckets([v[key] for v in per_leaf],
                                           _single(b, plan.pad_to))[b.name]
            else:
                out[key] = first
        state[j] = out
    return {"state": state, "param_groups": _groups(opt_state["param_groups"], len(plan.buckets))}


def _single(b: Bucket, pad_to: int) -> BucketPlan:
    """A plan of ``b`` alone over its own leaves, in order."""
    local = dataclasses.replace(b, indices=tuple(range(len(b.indices))))
    return BucketPlan(buckets=(local,), n_leaves=len(b.indices), pad_to=pad_to)


def unflatten_opt_state(opt_state: Dict[str, Any], plan: BucketPlan, params_template: Any) -> Dict[str, Any]:
    """Inverse of :func:`flatten_opt_state`: the flat layout as a dense
    ``state_dict`` indexed by leaf (padding dropped)."""
    n = plan.n_leaves
    state = {}
    for j, b in enumerate(plan.buckets):
        flat = opt_state["state"].get(j)
        if flat is None:
            continue
        for key, value in flat.items():
            if isinstance(value, torch.Tensor) and value.dim() == 1 and value.shape[0] == b.padded_size:
                parts = unflatten_buckets({b.name: value}, _single(b, plan.pad_to), range(len(b.indices)))
                for i, part in zip(b.indices, parts):
                    state.setdefault(i, {})[key] = part.clone()
            else:
                for i in b.indices:
                    state.setdefault(i, {})[key] = value.clone() if isinstance(value, torch.Tensor) else value
    return {"state": dict(sorted(state.items())), "param_groups": _groups(opt_state["param_groups"], n)}


def reflatten_opt_state(opt_state: Dict[str, Any], old_plan: BucketPlan, new_plan: BucketPlan,
                        params_template: Any) -> Dict[str, Any]:
    """Re-bucket a flat ZeRO state across plans (``bucket_mb`` or data
    width changed): old flats, dense mirrors, new flats."""
    dense = unflatten_opt_state(opt_state, old_plan, params_template)
    return flatten_opt_state(dense, new_plan, params_template)


def opt_state_bytes_per_device(state) -> int:
    """The bytes of optimizer state this rank holds for a
    :class:`~maggy_tpu_torch.train.TrainState` (a DTensor counts its local
    shard). JAX's counts the same from shapes and shardings; the ZeRO-1
    check is that this shrinks to about ``1/data`` of the dense layout's."""
    total = 0
    for per_param in state.optimizer.state.values():
        for value in per_param.values():
            if isinstance(value, torch.Tensor):
                local = value.to_local() if hasattr(value, "to_local") else value
                total += local.numel() * local.element_size()
    return int(total)


# ----------------------------------------------------------- the two steps


def _reduce_scatter(dist):
    """``reduce_scatter_single`` where this torch has it (it deprecates
    ``reduce_scatter_tensor``, which older releases alone have)."""
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_flat(dist):
    """``all_gather_single`` where this torch has it, else
    ``all_gather_into_tensor``."""
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class BucketedGrads:
    """Per-bucket reduction of ``params``' gradients over ``group`` during
    backward. ``params`` are the plan's leaves in flatten order. Each
    parameter's hook copies its accumulated gradient into its bucket's flat
    buffer and drops it; a full bucket starts its collective at once,
    asynchronously: an all-reduce, or with ``shards`` (ZeRO-1) a
    reduce-scatter into this rank's shard. Buckets start in plan order on
    every rank. On a sliced mesh ``group`` is ``data`` and ``outer`` the
    ``slice`` group: each reduced bucket (or shard) is then summed over the
    slices as well, the cross-slice sum after the intra-slice one, as JAX's
    step sums over ``data`` first, then over ``slice``.

    :meth:`begin` before backward; :meth:`finish` after it waits for every
    bucket (starting any a gradient never reached, with zeros there)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], plan: BucketPlan, group, shards: int = 1,
                 rank: int = 0, outer=None):
        self.plan, self.group, self.shards, self.rank, self.outer = plan, group, shards, rank, outer
        self.params = list(params)
        kinds = [dict(dtype=self.params[b.indices[0]].dtype, device=self.params[b.indices[0]].device)
                 for b in plan.buckets]
        self.flats = [torch.zeros(b.padded_size, **kind) for b, kind in zip(plan.buckets, kinds)]
        self.out = [torch.empty(b.padded_size // shards, **kind) for b, kind in zip(plan.buckets, kinds)
                    ] if shards > 1 else self.flats
        self._slot = {}  # leaf index -> (bucket, offset, size)
        for j, b in enumerate(plan.buckets):
            off = 0
            for i, size in zip(b.indices, b.sizes):
                self._slot[i] = (j, off, size)
                off += size
        self._handles = [p.register_post_accumulate_grad_hook(self._hook(i)) for i, p in enumerate(self.params)]
        self.begin()

    def begin(self) -> None:
        self._left = [len(b.indices) for b in self.plan.buckets]
        self._work: List[Any] = [None] * len(self.plan.buckets)
        self._next = 0
        self._seen = set()

    def _hook(self, i: int):
        # autograd keeps a hook in its C++ node, out of the cycle collector's
        # sight: holding this object strongly there would keep every
        # parameter and flat buffer alive after the state is dropped
        ref = weakref.ref(self)

        def hook(p):
            me = ref()
            if me is None:
                return
            j, off, size = me._slot[i]
            me.flats[j][off:off + size].copy_(p.grad.reshape(-1))
            p.grad = None
            me._seen.add(i)
            me._left[j] -= 1
            me._launch_ready()

        return hook

    def _launch_ready(self) -> None:
        import torch.distributed as dist

        while self._next < len(self._left) and self._left[self._next] == 0:
            j = self._next
            if self.shards > 1:
                self._work[j] = _reduce_scatter(dist)(self.out[j], self.flats[j], group=self.group,
                                                      async_op=True)
            else:
                self._work[j] = dist.all_reduce(self.flats[j], group=self.group, async_op=True)
            self._next += 1

    def finish(self) -> List[torch.Tensor]:
        """Wait for every bucket; returns the reduced flat buffers (the
        shards under ZeRO-1)."""
        for i, (j, off, size) in self._slot.items():
            if i not in self._seen:  # a parameter backward never reached
                self.flats[j][off:off + size].zero_()
                self._left[j] -= 1
        self._launch_ready()
        for w in self._work:
            w.wait()
        if self.outer is not None:
            import torch.distributed as dist

            for out in self.out:
                dist.all_reduce(out, group=self.outer)
        return self.out

    def grad_views(self) -> List[torch.Tensor]:
        """Each parameter's reduced gradient, a view into its bucket's
        flat buffer (bucket mode)."""
        return unflatten_buckets({b.name: f for b, f in zip(self.plan.buckets, self.flats)}, self.plan,
                                 [p.shape for p in self.params])

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


class ZeroShards:
    """ZeRO-1's parameters: ``params`` (the plan's leaves in flatten order)
    become views into one flat padded buffer per bucket, and
    :attr:`shards` are the optimizer's leaves, this rank's ``1/dz`` of each
    buffer (views into it too). :meth:`gather` all-gathers every shard
    back into its buffer, which updates the parameters in place."""

    def __init__(self, params: Sequence[torch.nn.Parameter], plan: BucketPlan, group, dz: int, rank: int):
        self.plan, self.group, self.dz, self.rank = plan, group, dz, rank
        self.params = list(params)
        with torch.no_grad():
            flats = flatten_buckets([p.detach() for p in self.params], plan)
        self.flats = [flats[b.name] for b in plan.buckets]
        for p, view in zip(self.params, unflatten_buckets(flats, plan, self.params)):
            p.data = view
        self.shards = [torch.nn.Parameter(self._mine(f)) for f in self.flats]

    def _mine(self, flat: torch.Tensor) -> torch.Tensor:
        n = flat.shape[0] // self.dz
        return flat[self.rank * n:(self.rank + 1) * n]

    @torch.no_grad()
    def gather(self) -> None:
        import torch.distributed as dist

        work = [all_gather_flat(dist)(flat, shard.detach(), group=self.group, async_op=True)
                for flat, shard in zip(self.flats, self.shards)]
        for w in work:
            w.wait()


@dataclasses.dataclass
class OverlapLayout:
    """What a bucketed (``mode="bucket"``) or ZeRO-1 (``"zero"``) train
    state carries: the plan over the parameters in JAX's flatten order
    (``names``), the ``data`` group, the shard count ``dz`` and this rank's
    place in it, the per-bucket reduction and, under ZeRO-1, the flat
    parameter buffers and their shards."""

    mode: str
    plan: BucketPlan
    names: Tuple[str, ...]
    group: Any
    dz: int
    rank: int
    grads: BucketedGrads
    zero: Optional[ZeroShards] = None

    def update(self, optimizer) -> torch.Tensor:
        """After backward: wait for every bucket, hand the optimizer its
        gradients and step it; returns the global grad norm. Bucket mode:
        each parameter's gradient is a view into its reduced bucket, the
        norm is taken from them (equal on every rank). ZeRO-1: each shard's
        gradient is its reduce-scattered slice, the norm the square root of
        the shards' squares summed over ``data``; after the step the shards
        are all-gathered back into the parameters."""
        import torch.distributed as dist

        reduced = self.grads.finish()
        if self.zero is None:
            views = self.grads.grad_views()
            for p, g in zip(self.grads.params, views):
                p.grad = g
            gnorm = torch.nn.utils.get_total_norm(views)
            optimizer.step()
            return gnorm
        for shard, g in zip(self.zero.shards, reduced):
            shard.grad = g
        sq = torch.stack([g.float().square().sum() for g in reduced]).sum()
        dist.all_reduce(sq, group=self.group)
        optimizer.step()
        self.zero.gather()
        return sq.sqrt()

    def remove(self) -> None:
        self.grads.remove()


# ------------------------------------------------------------ measurement


def measure_step_times(entries: Dict[str, Tuple[Any, Any]], batch, repeats: int = 5) -> Dict[str, float]:
    """Min-of-``repeats`` wall time (ms) per labelled step variant.

    ``entries`` maps label -> ``(step_fn, state)`` where ``step_fn(state,
    batch) -> (state, metrics)`` (a ``Trainer.step``) and ``state`` is that
    variant's own state. The first call per variant is an untimed warm-up;
    each timed call ends in a read of its loss, which waits for the
    device."""
    import time as _time

    out = {}
    for label, (fn, state) in entries.items():
        state, metrics = fn(state, batch)
        float(metrics["loss"])
        best = float("inf")
        for _ in range(max(1, int(repeats))):
            t0 = _time.perf_counter()
            state, metrics = fn(state, batch)
            float(metrics["loss"])
            best = min(best, (_time.perf_counter() - t0) * 1e3)
        out[label] = best
    return out


def record_overlap_gauges(times: Dict[str, float], manual_axes, telemetry_recorder=None) -> Dict[str, float]:
    """Fold measured step times into the ``train.comm_*`` gauges.

    ``times`` needs ``dense`` (the unbucketed step), ``bucketed`` (the
    overlap step) and ``nocomm`` (the overlap step with every reduction
    stripped: pure compute); optional ``only_<axis>`` entries (reduction
    over one mesh axis only) give per-axis exposure gauges. total comm =
    dense - nocomm; exposed = bucketed - nocomm; overlapped = total -
    exposed."""
    from maggy_tpu_torch import telemetry

    tel = telemetry_recorder if telemetry_recorder is not None else telemetry.get()
    nocomm = times["nocomm"]
    total = max(times["dense"] - nocomm, 0.0)
    exposed = max(times["bucketed"] - nocomm, 0.0)
    overlapped = max(total - exposed, 0.0)
    tel.gauge("train.comm_exposed_ms", exposed)
    tel.gauge("train.comm_overlapped_ms", overlapped)
    out = {"comm_total_ms": total, "comm_exposed_ms": exposed, "comm_overlapped_ms": overlapped}
    for ax in manual_axes:
        key = f"only_{ax}"
        if key in times:
            ax_exposed = max(times[key] - nocomm, 0.0)
            tel.gauge(f"train.comm_exposed_ms.{ax}", ax_exposed)
            out[f"comm_exposed_ms_{ax}"] = ax_exposed
    return out
