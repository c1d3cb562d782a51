"""The port's MoE decoder on a mesh of gloo ranks against the JAX Trainer
under the same ``ShardingSpec``: expert parallelism alone (ep=2), with
FSDP (ep=2 x fsdp=2) and with data parallelism (ep=2 x dp=2); and the
ZeRO-1 step over dp=2 (small buckets), where each rank routes its own rows
and the router terms are the mean of the ranks' own, as in JAX's.

Each spec runs as one CPU process per rank (``torch.multiprocessing``
spawn, a file rendezvous, every wait under ``TIMEOUT_S``, one intra-op
thread a rank: ``OMP_NUM_THREADS=1``): ``TrainContext.create(spec,
device="cpu")``, ``MoEConfig.tiny_moe`` in fp32 from the JAX ``make_state``
weights, three AdamW steps (foreach, as on a card) on packed batches with a
``loss_mask``. ``group_size`` is 32: a batch rank's two rows of 32 tokens
then hold whole routing groups, so its groups are the ones JAX cuts from
the global batch (a shape that does not keep this raises, see
``tests/test_torch_moe.py``).

* Every rank's loss, aux loss and grad norm at each step within 2e-5
  relative of JAX's, and every parameter after the last step within 5e-5
  absolute (the experts gathered whole over ``expert``).
* Each run saves a checkpoint after step 2 (rank 0 writes every expert
  whole) and ``fit(resume="auto")`` resumes it, ending on the
  uninterrupted trajectory's loss; the ep=2 x fsdp=2 run resumes the ep=2
  run's, and a one-device trainer restores it too.
"""

import functools
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.models import MoEConfig, MoEDecoder
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.train import Checkpointer, TrainContext, Trainer, adamw

TIMEOUT_S = 120
LR = 5e-3
OPTIMIZER = functools.partial(adamw(LR), foreach=True)
STEPS = 3
B, S = 4, 32
GROUP = 32
RTOL = 2e-5
# fp32 parameters after three AdamW steps: a gradient element near zero
# makes Adam's normalised update sensitive to the last bits of the
# gradient, whose sums over ranks and rows run in another order than JAX's
# (measured: at most 2.2e-5 in one element of 4096 under ep2 x fsdp2)
PARAM_ATOL = 5e-5
SPECS = {"ep2": dict(ep=2), "ep2_fsdp2": dict(ep=2, fsdp=2), "ep2_dp2": dict(ep=2, dp=2),
         "dp2_zero1": dict(dp=2, zero_stage=1, bucket_mb=0.05)}


def _cfg():
    return MoEConfig.tiny_moe(dtype=torch.float32, group_size=GROUP)


def packed_batches(vocab: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cuts = [np.sort(rng.choice(np.arange(4, S - 4), rng.integers(0, 3), replace=False)) for _ in range(B)]
        seg = np.stack([np.searchsorted(c, np.arange(S), side="right") for c in cuts]).astype(np.int32)
        pos = np.stack([np.arange(S) - np.concatenate([[0], c])[s] for c, s in zip(cuts, seg)]).astype(np.int32)
        out.append({
            "tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "positions": pos,
            "segment_ids": seg,
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32),
        })
    return out


def _whole(model):
    """Every parameter whole (a collective: every rank calls it)."""
    from maggy_tpu_torch.parallel.expert import expert_params, gather_expert_tensor

    experts = expert_params(model)
    out = {}
    for name, p in model.named_parameters():
        if name in experts:
            t = gather_expert_tensor(p, experts[name][1])
        else:
            t = p.full_tensor() if hasattr(p, "full_tensor") else p
        out[name] = t.detach().numpy().copy()
    return out


def _rank(rank, n, init_file, out, spec_kw, params, batches, ckpt_dir, restore_from):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
        ctx = TrainContext.create(ShardingSpec(**spec_kw), device="cpu")
        init = {k: torch.from_numpy(v) for k, v in params.items()}

        def fresh():
            trainer = ctx.trainer(MoEDecoder(_cfg(), device="meta"), OPTIMIZER)
            return trainer, trainer.make_state(0, batches[0], params=init)

        trainer, state = fresh()
        ckpt = Checkpointer(f"{ckpt_dir}/steps", async_save=False)
        metrics = []
        for i, batch in enumerate(batches[1:]):
            if i == STEPS - 1:
                ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
            state, m = trainer.step(state, ctx.shard_batch(batch))
            metrics.append([float(m[k]) for k in ("loss", "aux_loss", "grad_norm", "total_loss")])
        ckpt.close()
        final = _whole(state.model)
        # ``fit(resume="auto")`` from the step-2 checkpoint (this run's, or
        # under ep2 x fsdp2 the ep2 run's): it ends on step 3's loss
        trainer2, state2 = fresh()
        ckpt = Checkpointer(f"{restore_from or ckpt_dir}/steps", async_save=False)
        state2, m2 = trainer2.fit(state2, iter(batches[1:]), STEPS, checkpointer=ckpt, resume="auto", prefetch=0)
        ckpt.close()
        out.put((rank, dict(metrics=metrics, final=final if rank == 0 else None,
                            resumed=(m2["resumed_from"], state2.step, m2["loss"]),
                            experts=tuple(state.model.layers[0].moe.w_gate.shape)[:1])))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _run_ranks(n, tmp_path, *args):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, str(tmp_path / "rendezvous"), out, *args)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=TIMEOUT_S) for _ in range(n)), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [f"rank {r[0]} failed:\n{r[2]}" for r in results if isinstance(r[1], str) and r[1] == "error"]
    if failed:
        raise AssertionError("\n".join(failed))
    return [r[1] for r in results]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(key)``: the JAX trajectory and the port's ranks under
    ``SPECS[key]``, computed once for the module (ep2 first: the ep2 x
    fsdp2 run restores its checkpoint)."""
    runs = {}
    mp_env = pytest.MonkeyPatch()
    mp_env.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks inherit it

    def get(key):
        if key not in runs:
            restore_from = get("ep2")["ckpt_dir"] if key == "ep2_fsdp2" else None
            runs[key] = _both(SPECS[key], tmp_path_factory.mktemp(key), restore_from)
        return runs[key]

    yield get
    mp_env.undo()


def _both(spec_kw, tmp, restore_from):
    # the JAX package is imported here: the spawned ranks import this
    # module and need only the port
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import MoEConfig as JConfig
    from maggy_tpu.models import MoEDecoder as JMoE
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.convert import moe_params_from_flax

    spec = JShardingSpec(**spec_kw)
    n = spec.num_devices
    jctx = JTrainContext.create(spec, devices=jax.devices()[:n])
    jcfg = JConfig.tiny_moe(dtype=jnp.float32, group_size=GROUP)
    batches = packed_batches(jcfg.vocab_size, STEPS + 1)
    jtr = jctx.trainer(JMoE(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), batches[0])

    def torch_params(state):
        return {k: v.numpy() for k, v in moe_params_from_flax(jax.device_get(unbox(state.params)), _cfg()).items()}

    params = torch_params(jstate)
    want = []
    for batch in batches[1:]:
        jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
        want.append([float(jm[k]) for k in ("loss", "aux_loss", "grad_norm", "total_loss")])
    ckpt_dir = str(tmp / "ckpt")
    ranks = _run_ranks(n, tmp, spec_kw, params, batches, ckpt_dir, restore_from)
    return dict(want=np.array(want), jparams=torch_params(jstate), init=params, batches=batches, ranks=ranks,
                ckpt_dir=ckpt_dir)


@pytest.mark.parametrize("key", list(SPECS))
def test_moe_trains_expert_parallel(run, key):
    """The port's counterpart of JAX's ``test_moe_trains_expert_parallel``,
    held to the JAX Trainer step by step."""
    r = run(key)
    want = r["want"]
    assert want[-1, 0] < want[0, 0] and (want[:, 1] > 0).all()  # it learns; the router terms count
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["metrics"], want, rtol=RTOL)
        assert rank["experts"] == (4 // SPECS[key].get("ep", 1),)  # a rank's experts (before FSDP2's split)
    final = r["ranks"][0]["final"]
    assert sorted(final) == sorted(r["jparams"])
    for name, w in r["jparams"].items():
        np.testing.assert_allclose(final[name], w, rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert not np.array_equal(final[name], r["init"][name]) or name.endswith("scale")


@pytest.mark.parametrize("key", list(SPECS))
def test_checkpoints_restore_and_resume(run, key):
    """``fit(resume="auto")`` from the step-2 checkpoint (under ep2 x fsdp2
    the ep2 run's, written on another mesh) takes step 3 alone and ends on
    the uninterrupted loss."""
    r = run(key)
    for rank in r["ranks"]:
        want = (run("ep2")["ranks"][0] if key == "ep2_fsdp2" else rank)["metrics"][-1][0]
        resumed_from, end, loss = rank["resumed"]
        assert (resumed_from, end) == (STEPS - 1, STEPS)
        assert loss == pytest.approx(want, rel=RTOL)


def test_ep_checkpoint_restores_on_one_device(run):
    """The ep=2 checkpoint is the one-device format, every expert whole: a
    one-device trainer restores it and takes step 3 to the same loss."""
    r = run("ep2")
    trainer = Trainer(MoEDecoder(_cfg(), device="meta"), adamw(LR), device="cpu")
    state = trainer.make_state(0, r["batches"][0], params={k: torch.from_numpy(v) for k, v in r["init"].items()})
    ckpt = Checkpointer(f"{r['ckpt_dir']}/steps")
    assert ckpt.saved_meta()["mesh_axes"] == {"expert": 2}
    assert ckpt.restore_params()["layers.0.moe.w_gate"].shape == (4, 64, 96)
    state = ckpt.restore(state)
    assert state.step == STEPS - 1
    _, m = trainer.step(state, r["batches"][STEPS])
    assert float(m["loss"]) == pytest.approx(r["ranks"][0]["metrics"][-1][0], rel=RTOL)
    assert float(m["aux_loss"]) == pytest.approx(r["want"][-1][1], rel=RTOL)
