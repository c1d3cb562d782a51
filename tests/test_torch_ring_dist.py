"""The process-group ring and the sequence-parallel trainer, across processes.

Two CPU processes join a ``gloo`` group (a file rendezvous in the test's
temporary directory) and each holds one chunk of the sequence, as one card
per rank would under NCCL. The ranks run under ``torch.multiprocessing``
with the spawn start method; each test waits at most ``TIMEOUT_S`` seconds
for every rank's result and kills any rank still alive.

* ``ProcessGroupRing`` output and gradients equal ``LocalRing(2)``'s: the
  two rings call the same step functions in the same order on the same
  chunks, so they agree to the last bit (held to 1e-6).
* The trainer's bucketed gradient sum equals one all-reduce per tensor,
  bit for bit, across buckets, a tensor larger than a bucket and a change
  of dtype.
* A 3-step loss and grad-norm trajectory of the port's ``Trainer`` under
  ``TrainContext.create(ShardingSpec(sp=2))``, from the JAX trainer's
  initial weights converted by ``decoder_params_from_flax``, matches the
  JAX ``Trainer`` under ``ShardingSpec(sp=2)`` with ``make_ring_attention``
  on 2 CPU devices, to rtol 2e-5 as ``tests/test_torch_trainer.py`` holds
  the dense trajectory (fp32; the loss parts and gradients are summed over
  the ranks in another order).
"""

import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import (
    LocalRing,
    ProcessGroupRing,
    ShardingSpec,
    make_ring_attention,
    ring_attention,
)
from maggy_tpu_torch.train import TrainContext, adamw

TIMEOUT_S = 120
N = 2
LR = 5e-3
STEPS = 3


def _join_group(rank, init_file):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=N)


def _ring_rank(rank, init_file, out, q, k, v, g, segs, causal):
    import torch.distributed as dist

    try:
        _join_group(rank, init_file)
        c = q.shape[1] // N
        rows = slice(rank * c, (rank + 1) * c)
        leaves = [torch.from_numpy(t[:, rows]).requires_grad_(True) for t in (q, k, v)]
        seg = None if segs is None else torch.from_numpy(segs[:, rows])
        o = ring_attention(*leaves, ring=ProcessGroupRing(), causal=causal, segment_ids=seg)
        o.backward(torch.from_numpy(g[:, rows]))
        out.put((rank, o.detach().numpy(), [t.grad.numpy() for t in leaves]))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _trainer_rank(rank, init_file, out, params, batches):
    import torch.distributed as dist

    try:
        _join_group(rank, init_file)
        ctx = TrainContext.create(ShardingSpec(sp=N), device="cpu")
        assert (ctx.process_index, ctx.num_processes) == (rank, N)
        cfg = DecoderConfig.tiny(dtype=torch.float32, attention_fn=make_ring_attention(ctx.ring))
        trainer = ctx.trainer(Decoder(cfg, device="meta"), adamw(LR))
        state = trainer.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in params.items()})
        losses, norms = [], []
        for batch in batches[1:]:
            state, metrics = trainer.step(state, ctx.shard_batch(batch))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out.put((rank, losses, norms))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _sum_rank(rank, init_file, out, sizes, bucket_bytes):
    import torch.distributed as dist

    from maggy_tpu_torch.train.trainer import _all_reduce_sum

    try:
        _join_group(rank, init_file)
        gen = torch.Generator().manual_seed(rank)
        tensors = [torch.randn(n, generator=gen, dtype=dtype) for n, dtype in sizes]
        want = [t.clone() for t in tensors]
        for t in want:
            dist.all_reduce(t)
        _all_reduce_sum(tensors, None, bucket_bytes=bucket_bytes)
        out.put((rank, [t.numpy() for t in tensors], [t.numpy() for t in want]))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _run_ranks(target, tmp_path, *args):
    """Every rank's result, in rank order; raises with a rank's traceback,
    or after TIMEOUT_S, and leaves no rank running."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init_file = tmp_path / "rendezvous"
    procs = [ctx.Process(target=target, args=(r, str(init_file), out, *args)) for r in range(N)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=TIMEOUT_S) for _ in range(N)), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in results:
        if isinstance(r[1], str) and r[1] == "error":
            raise AssertionError(f"rank {r[0]} failed:\n{r[2]}")
    return results


@pytest.mark.parametrize("causal,packed", [(True, False), (True, True), (False, True)])
def test_process_group_ring_matches_local_ring(tmp_path, causal, packed):
    rng = np.random.default_rng(0)
    b, s, h, kh, d = 2, 32, 4, 2, 8
    q, g = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))
    segs = np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32) if packed else None

    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    ref = ring_attention(*leaves, ring=LocalRing(N), causal=causal,
                         segment_ids=None if segs is None else torch.from_numpy(segs))
    ref.backward(torch.from_numpy(g))

    results = _run_ranks(_ring_rank, tmp_path, q, k, v, g, segs, causal)
    o = np.concatenate([r[1] for r in results], axis=1)
    np.testing.assert_allclose(o, ref.detach().numpy(), atol=1e-6, rtol=0)
    for i, (name, leaf) in enumerate(zip(("dq", "dk", "dv"), leaves)):
        grad = np.concatenate([r[2][i] for r in results], axis=1)
        np.testing.assert_allclose(grad, leaf.grad.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_bucketed_gradient_sum_matches_per_tensor_sums(tmp_path):
    """The trainer sums gradients over the group in buckets: tensors that
    share a bucket, a tensor larger than a bucket (reduced alone) and a
    change of dtype all give each tensor's own all-reduce, bit for bit."""
    sizes = [(3, torch.float32), (100, torch.float32), (5, torch.float32), (7, torch.float32),
             (4, torch.float64), (6, torch.float32)]
    for rank, got, want in _run_ranks(_sum_rank, tmp_path, sizes, 64):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_sp2_trainer_matches_jax_trainer(tmp_path):
    # the JAX package is imported here, not at the top: the spawned ranks
    # import this module and need only the port
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.ringattention import make_ring_attention as jmake_ring_attention
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu.train import data as jdata
    from maggy_tpu_torch.convert import decoder_params_from_flax

    jctx = JTrainContext.create(JShardingSpec(sp=N), devices=jax.devices()[:N])
    jcfg = JConfig.tiny(dtype=jnp.float32, attention_fn=jmake_ring_attention(jctx.mesh))
    stream = jdata.synthetic_lm_batches(jcfg.vocab_size, 4, 32, seed=0)
    batches = [{k: np.asarray(v) for k, v in next(stream).items()} for _ in range(STEPS + 1)]
    jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), batches[0])
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    params = {k: v.numpy() for k, v in
              decoder_params_from_flax(jax.device_get(unbox(jstate.params)), tcfg).items()}
    jl, jg = [], []
    for batch in batches[1:]:
        jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
        jl.append(float(jm["loss"]))
        jg.append(float(jm["grad_norm"]))

    results = _run_ranks(_trainer_rank, tmp_path, params, batches)
    for _, losses, norms in results:  # every rank reports the global loss
        np.testing.assert_allclose(losses, jl, rtol=2e-5)
        np.testing.assert_allclose(norms, jg, rtol=2e-5)
    assert jl[-1] < jl[0]
