"""Ring attention: sequence parallelism over a ring of ranks.

Counterpart of :mod:`maggy_tpu.parallel.ringattention` with the kernels of
:mod:`maggy_tpu.ops.ring_flash`. The global sequence is cut into n equal
chunks, one per rank. Each rank attends its q chunk to every KV chunk as the
chunks travel round the ring: at step s it holds the chunk owned by rank
``(my - s) mod n``. The online-softmax state stays with the q chunk; the
backward recomputes the probabilities from the saved LSE, keeps dQ local and
folds dK/dV into fp32 accumulators that travel with their chunk, so a last
rotation delivers each chunk's dK/dV to its owner. Nothing of size [S, S]
exists anywhere.

The compute of a step is :mod:`maggy_tpu_torch.ops.ring_flash` (the CUDA
kernels, or their plain versions on the CPU). The transport is the ring's:

* :class:`ProcessGroupRing` is the multi-card path: one process per rank,
  each holding its chunk. KV (and its segment ids) is sent to rank+1 and
  received from rank-1 with ``torch.distributed.batch_isend_irecv`` on a
  side CUDA stream, double-buffered and issued before the step's compute so
  that the two overlap; in the backward dK/dV travel after the compute.
* :class:`LocalRing` runs the n ranks of the same schedule in one process on
  one device: the caller passes the global sequence and a rotation is index
  arithmetic with no copy. It exists for one-card runs and CPU tests, and is
  only used where the caller names it.

Both call the same step functions in the same order, so they sum in the same
order. With ``causal`` a chunk wholly in a rank's future is skipped (no
launch); the chunk's own KV is the causal diagonal; a past chunk has no mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from maggy_tpu_torch.ops import ring_flash


def _visits(my: int, n: int, causal: bool):
    """``(step, src, diagonal)`` of every step rank ``my`` computes, in
    order: at step s it holds the KV chunk of rank ``(my - s) mod n``."""
    out = []
    for s in range(n):
        src = (my - s) % n
        if causal and src > my:
            continue  # the chunk lies wholly in the causal future
        out.append((s, src, causal and src == my))
    return out


class LocalRing:
    """n ranks of the ring in one process: q/k/v are the global
    ``[B, S, ...]`` tensors and rank r's chunk is ``[:, r*C:(r+1)*C]``."""

    def __init__(self, n: int):
        if not isinstance(n, int) or n < 1:
            raise ValueError(f"LocalRing needs a positive number of ranks, got {n!r}")
        self.size = n

    def visits(self, my: int, causal: bool):
        return _visits(my, self.size, causal)

    def _chunk(self, seq: int) -> int:
        if seq % self.size:
            raise ValueError(
                f"sequence length {seq} does not divide into {self.size} equal ring chunks"
            )
        return seq // self.size

    def _order(self, causal: bool):
        """Every (rank, step, src, diagonal) in schedule order: step by step,
        each rank's visit, as the ranks of a process-group ring run them."""
        per_rank = [self.visits(r, causal) for r in range(self.size)]
        for s in range(self.size):
            for r, visits in enumerate(per_rank):
                for step, src, diagonal in visits:
                    if step == s:
                        yield r, step, src, diagonal, step == visits[-1][0]

    def forward(self, q, k, v, segs, causal):
        b, seq, h, d = q.shape
        c = self._chunk(seq)
        fwd, _, _ = ring_flash.step_functions(q)
        f32 = dict(dtype=torch.float32, device=q.device)
        acc = torch.empty((b, seq, h, d), **f32)
        m, l, lse = (torch.empty((b, h, seq), **f32) for _ in range(3))
        o = torch.empty_like(q, memory_format=torch.contiguous_format)

        def rows(r):
            return slice(r * c, (r + 1) * c)

        for r, step, src, diagonal, last in self._order(causal):
            mine, theirs = rows(r), rows(src)
            fwd(q[:, mine], k[:, theirs], v[:, theirs], acc[:, mine], m[..., mine], l[..., mine],
                o[:, mine], lse[..., mine], diagonal=diagonal, first=step == 0, finalize_step=last,
                q_segs=None if segs is None else segs[:, mine],
                k_segs=None if segs is None else segs[:, theirs])
        return o, lse

    def backward(self, q, k, v, o, do, lse, segs, causal):
        b, seq, h, d = q.shape
        c = self._chunk(seq)
        _, dq_step, dkv_step = ring_flash.step_functions(q)
        dq = torch.empty((b, seq, h, d), dtype=torch.float32, device=q.device)
        dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
        for r, step, src, diagonal, _ in self._order(causal):
            mine, theirs = slice(r * c, (r + 1) * c), slice(src * c, (src + 1) * c)
            args = (q[:, mine], k[:, theirs], v[:, theirs], o[:, mine], do[:, mine], lse[..., mine])
            kw = dict(diagonal=diagonal, first=step == 0,
                      q_segs=None if segs is None else segs[:, mine],
                      k_segs=None if segs is None else segs[:, theirs])
            dq_step(*args, dq[:, mine], **kw)
            dkv_step(*args, dk[:, theirs], dv[:, theirs], **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class ProcessGroupRing:
    """One rank of a ring over a ``torch.distributed`` process group (the
    default group unless one is given): q ``[B, C, H, D]`` and k/v
    ``[B, C, Kh, D]`` are this rank's chunk of the global sequence."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupRing needs an initialised torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        # global ranks of the neighbours: chunks go right and come from the left
        self.right = dist.get_global_rank(group, (self.rank + 1) % self.size) if group else (self.rank + 1) % self.size
        self.left = dist.get_global_rank(group, (self.rank - 1) % self.size) if group else (self.rank - 1) % self.size
        self._side = {}

    def visits(self, my: int, causal: bool):
        return _visits(my, self.size, causal)

    def _side_stream(self, device):
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def _rotate(self, send, recv):
        """Start sending ``send`` to the right neighbour and receiving
        ``recv`` from the left one; returns the pending requests. On CUDA the
        ops are issued on a side stream that first waits for the work queued
        so far, so they overlap the compute that follows."""
        import torch.distributed as dist

        ops = []
        for out, into in zip(send, recv):
            ops.append(dist.P2POp(dist.isend, out, self.right, self.group))
            ops.append(dist.P2POp(dist.irecv, into, self.left, self.group))
        if not send[0].is_cuda:
            return dist.batch_isend_irecv(ops)
        side = self._side_stream(send[0].device)
        side.wait_stream(torch.cuda.current_stream(send[0].device))
        with torch.cuda.stream(side):
            return dist.batch_isend_irecv(ops)

    def _wait(self, reqs) -> None:
        if not reqs:
            return
        for req in reqs:
            req.wait()  # on CUDA: the current stream waits for the transfer

    def forward(self, q, k, v, segs, causal):
        b, c, h, d = q.shape
        fwd, _, _ = ring_flash.step_functions(q)
        f32 = dict(dtype=torch.float32, device=q.device)
        acc = torch.empty((b, c, h, d), **f32)
        m, l, lse = (torch.empty((b, h, c), **f32) for _ in range(3))
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        cur = [t.contiguous() for t in (k, v, segs) if t is not None]  # sent whole
        spare = [[torch.empty_like(t) for t in cur] for _ in range(2)]
        visits = {s: (src, diagonal) for s, src, diagonal in self.visits(self.rank, causal)}
        last = max(visits)
        for s in range(self.size):
            reqs = None
            if s < self.size - 1:  # the next chunk travels while this one is computed
                nxt = spare[s % 2]
                reqs = self._rotate(cur, nxt)
            if s in visits:
                _, diagonal = visits[s]
                fwd(q, cur[0], cur[1], acc, m, l, o, lse, diagonal=diagonal, first=s == 0,
                    finalize_step=s == last, q_segs=segs,
                    k_segs=None if segs is None else cur[2])
            self._wait(reqs)
            if reqs:
                cur = nxt
        return o, lse

    def backward(self, q, k, v, o, do, lse, segs, causal):
        b, c, h, d = q.shape
        _, dq_step, dkv_step = ring_flash.step_functions(q)
        dq = torch.empty((b, c, h, d), dtype=torch.float32, device=q.device)
        cur = [t.contiguous() for t in (k, v, segs) if t is not None]  # sent whole
        spare = [[torch.empty_like(t) for t in cur] for _ in range(2)]
        # the visiting chunk's dK/dV accumulators, double-buffered
        acc = [[torch.empty(k.shape, dtype=torch.float32, device=q.device) for _ in range(2)]
               for _ in range(2)]
        dkv = acc[0]
        visits = {s: diagonal for s, _, diagonal in self.visits(self.rank, causal)}
        pending = None  # the accumulators in flight from the previous step
        for s in range(self.size):
            reqs = None
            if s < self.size - 1:  # k/v are read-only: they travel under the compute
                nxt = spare[s % 2]
                reqs = self._rotate(cur, nxt)
            kw = dict(diagonal=visits.get(s, False), first=s == 0, q_segs=segs,
                      k_segs=None if segs is None else cur[2])
            args = (q, cur[0], cur[1], o, do, lse)
            if s in visits:
                dq_step(*args, dq, **kw)
            self._wait(pending)  # the visiting chunk's accumulators have arrived
            if s in visits:
                dkv_step(*args, dkv[0], dkv[1], **kw)
            # dK/dV travel after the compute; the last rotation takes each
            # chunk's accumulators home
            into = acc[(s + 1) % 2]
            pending = self._rotate(dkv, into)
            dkv = into
            self._wait(reqs)
            if reqs:
                cur = nxt
        self._wait(pending)
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """Mirror of ``ring_flash_attention``'s custom VJP: the forward saves q,
    k, v, O and the LSE; the backward is a second ring (no [S, S] residual)."""

    @staticmethod
    def forward(ctx, q, k, v, segs, ring, causal):
        o, lse = ring.forward(q, k, v, segs, causal)
        ctx.save_for_backward(q, k, v, o, lse, segs)
        ctx.ring, ctx.causal = ring, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segs = ctx.saved_tensors
        dq, dk, dv = ctx.ring.backward(q, k, v, o, do.to(o.dtype), lse, segs, ctx.causal)
        return dq, dk, dv, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ring,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ring attention over ``ring`` (a :class:`LocalRing` or a
    :class:`ProcessGroupRing`); differentiable. q ``[B, S, H, D]`` and k/v
    ``[B, S, Kh, D]`` are the global sequence for a ``LocalRing`` and this
    rank's chunk for a ``ProcessGroupRing``; ``segment_ids`` ``[B, S]`` (or
    the chunk's) for packed sequences. CUDA tensors run the ring kernels
    (bf16, head_dim 64 or 128, else ValueError); CPU tensors their plain
    versions."""
    if not isinstance(ring, (LocalRing, ProcessGroupRing)):
        raise TypeError(
            f"ring must be a LocalRing or a ProcessGroupRing, got {type(ring).__name__}"
        )
    segs = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return _RingAttention.apply(q, k, v, segs, ring, causal)


def make_ring_attention(ring):
    """An ``attention_fn`` for ``DecoderConfig`` over ``ring``, with the
    signature of ``default_attention``."""
    if not isinstance(ring, (LocalRing, ProcessGroupRing)):
        raise TypeError(
            f"ring must be a LocalRing or a ProcessGroupRing, got {type(ring).__name__}"
        )

    def attn(q, k, v, *, causal: bool = True, segment_ids=None):
        return ring_attention(q, k, v, ring=ring, causal=causal, segment_ids=segment_ids)

    return attn
