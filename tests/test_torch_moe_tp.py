"""The port's MoE decoder under tensor parallelism on gloo ranks against the
JAX Trainer under the same ``ShardingSpec``: ``tp=2``, ``tp=2 x fsdp=2`` and
``ep=2 x tp=2``.

Each spec runs as one CPU process per rank (``torch.multiprocessing``
spawn, a file rendezvous, every wait under ``TIMEOUT_S``, one intra-op
thread a rank: ``OMP_NUM_THREADS=1``), the runner of
``tests/test_torch_moe_dist.py``: ``TrainContext.create(spec,
device="cpu")``, ``MoEConfig.tiny_moe`` in fp32 from the JAX ``make_state``
weights, three AdamW steps (foreach, as on a card) on its packed batches
with a ``loss_mask``, ``group_size`` 32 (a batch rank's rows hold whole
routing groups). The two four-rank specs share one spawn; the JAX runs are
cached per module.

* Every rank's loss, aux loss, total loss and grad norm at each step within
  2e-5 relative of JAX's, and every parameter after the last step within
  2e-5 absolute (5e-5 under tp=2 x fsdp=2's batch split, as
  ``tests/test_torch_moe_dist.py`` holds its batch splits; the experts
  gathered whole over ``expert`` and ``tensor``).
* Every tensor rank routes the same tokens (each MoE block's router logits
  and top-k experts bit-equal across the ``tensor`` group), and the router
  and norm gradients of the first step are bit-equal across it and equal
  to JAX's gradient of the dense objective (loss + router terms) on the
  same weights and batch.
* Each run saves a checkpoint after step 2 (the one-device format: rank 0
  writes every parameter whole) and ``fit(resume="auto")`` resumes it,
  ending on the uninterrupted trajectory's loss; the tp=2 checkpoint also
  restores on one device.
"""

import functools
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from test_torch_moe_dist import _whole, packed_batches

from maggy_tpu_torch.models import MoEConfig, MoEDecoder
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.train import Checkpointer, TrainContext, Trainer, adamw

TIMEOUT_S = 120
LR = 5e-3
OPTIMIZER = functools.partial(adamw(LR), foreach=True)
STEPS = 3
GROUP = 32
RTOL = 2e-5
PARAM_ATOL = 2e-5
# under a batch split, the parameters after three AdamW steps as
# tests/test_torch_moe_dist.py holds them: a gradient element near zero
# makes Adam's update sensitive to the last bits of a gradient summed over
# the batch ranks in another order than JAX's (measured: 2.35e-5 in one
# element of lm_head's 16,384 under tp=2 x fsdp=2)
PARAM_ATOL_BATCH_SPLIT = 5e-5
SPECS = {"tp2": dict(tp=2), "tp2_fsdp2": dict(tp=2, fsdp=2), "ep2_tp2": dict(ep=2, tp=2)}
# the spawns: the specs each runs in turn over the same ranks
WORLDS = (("tp2",), ("tp2_fsdp2", "ep2_tp2"))
METRICS = ("loss", "aux_loss", "grad_norm", "total_loss")


def _cfg():
    return MoEConfig.tiny_moe(dtype=torch.float32, group_size=GROUP)


def replicated_grads(model) -> dict:
    """This rank's gradient shard of each router weight and norm scale."""
    return {name: getattr(p.grad, "to_local", lambda: p.grad)().detach().clone()
            for name, p in model.named_parameters() if name.endswith(("router.weight", "scale"))}


def record_routes(model) -> tuple:
    """Hooks that keep each MoE block's router logits and top-k experts of
    every forward; returns ``(routes, hooks)``."""
    from maggy_tpu_torch.models.moe import top_k_lowest_first
    from maggy_tpu_torch.parallel.expert import moe_blocks

    routes, hooks = [], []
    for _, block in moe_blocks(model):
        def keep(mod, args, out, k=block.cfg.top_k):
            logits = out.detach().clone()
            routes.append((logits, top_k_lowest_first(torch.softmax(logits.float(), -1), k)[1]))
        hooks.append(block.router.register_forward_hook(keep))
    return routes, hooks


def same_over_tensor(ctx, obj) -> bool:
    """Whether every rank of this rank's ``tensor`` group holds ``obj``
    bit for bit (a list or dict of tensors)."""
    import torch.distributed as dist

    group = ctx.mesh.get_group("tensor")
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, obj, group=group)
    items = (lambda o: list(o.values()) if isinstance(o, dict) else [t for pair in o for t in pair])
    return all(len(items(o)) == len(items(obj)) and all(torch.equal(a, b) for a, b in zip(items(o), items(obj)))
               for o in every)


def _rank(rank, n, init_file, out, keys, params, batches, ckpt_root):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
        out.put((rank, {key: _spec_body(key, params, batches, f"{ckpt_root}/{key}") for key in keys}))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _spec_body(key, params, batches, ckpt_dir):
    ctx = TrainContext.create(ShardingSpec(**SPECS[key]), device="cpu")
    init = {k: torch.from_numpy(v) for k, v in params.items()}

    def fresh():
        trainer = ctx.trainer(MoEDecoder(_cfg(), device="meta"), OPTIMIZER)
        return trainer, trainer.make_state(0, batches[0], params=init)

    trainer, state = fresh()
    ckpt = Checkpointer(f"{ckpt_dir}/steps", async_save=False)
    routes, hooks = record_routes(state.model)
    metrics, grads = [], None
    for i, batch in enumerate(batches[1:]):
        if i == STEPS - 1:
            ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
        state, m = trainer.step(state, ctx.shard_batch(batch))
        metrics.append([float(m[k]) for k in METRICS])
        if i == 0:
            grads = replicated_grads(state.model)
            whole_grads = {name: p.grad.full_tensor().numpy().copy() for name, p in state.model.named_parameters()
                           if name in grads}
            for hook in hooks:
                hook.remove()
    ckpt.close()
    final = _whole(state.model)
    trainer2, state2 = fresh()
    ckpt = Checkpointer(f"{ckpt_dir}/steps", async_save=False)
    state2, m2 = trainer2.fit(state2, iter(batches[1:]), STEPS, checkpointer=ckpt, resume="auto", prefetch=0)
    ckpt.close()
    import torch.distributed as dist

    return dict(metrics=metrics, final=final if dist.get_rank() == 0 else None,
                resumed=(m2["resumed_from"], state2.step, m2["loss"]),
                same_dispatch=len(routes) == 2 and same_over_tensor(ctx, routes),
                same_grads=same_over_tensor(ctx, grads), grads=whole_grads)


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
    failed = [f"rank {r[0]} failed:\n{r[2]}" for r in results if len(r) == 3]
    if failed:
        raise AssertionError("\n".join(failed))
    return [r[1] for r in results]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(key)``: the JAX trajectory, JAX's first-step gradients and the
    port's ranks under ``SPECS[key]``, computed once for the module."""
    worlds = {}
    mp_env = pytest.MonkeyPatch()
    mp_env.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks inherit it

    def get(key):
        keys = next(w for w in WORLDS if key in w)
        if keys not in worlds:
            worlds[keys] = _both(keys, tmp_path_factory.mktemp("_".join(keys)))
        return worlds[keys][key]

    yield get
    mp_env.undo()


def _both(keys, tmp):
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
    from maggy_tpu.train.trainer import collect_aux_losses, lm_loss_fn
    from maggy_tpu_torch.convert import moe_params_from_flax

    jcfg = JConfig.tiny_moe(dtype=jnp.float32, group_size=GROUP)
    batches = packed_batches(jcfg.vocab_size, STEPS + 1)

    def torch_params(tree):
        return {k: v.numpy() for k, v in moe_params_from_flax(jax.device_get(unbox(tree)), _cfg()).items()}

    out, params = {}, None
    for key in keys:
        spec = JShardingSpec(**SPECS[key])
        jtr = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices]).trainer(JMoE(jcfg), optax.adamw(LR))
        jstate = jtr.make_state(jax.random.key(0), batches[0])
        init = torch_params(jstate.params)
        if params is None:
            params = init
            b = {k: jnp.asarray(v) for k, v in batches[1].items()}

            def objective(p):  # the dense step's objective: loss and router terms
                logits, mods = JMoE(jcfg).apply({"params": p}, b["tokens"], b["positions"], b["segment_ids"],
                                                mutable=["intermediates"])
                return lm_loss_fn(logits, b) + collect_aux_losses(mods)

            jgrads = torch_params(jax.grad(objective)(jax.device_get(unbox(jstate.params))))
        for name, v in init.items():  # one set of weights for every spec
            np.testing.assert_array_equal(v, params[name])
        want = []
        for batch in batches[1:]:
            jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
            want.append([float(jm[k]) for k in METRICS])
        out[key] = dict(want=np.array(want), jparams=torch_params(jstate.params))
    ranks = _run_ranks(ShardingSpec(**SPECS[keys[0]]).num_devices, tmp, keys, params, batches, str(tmp / "ckpt"))
    for key in keys:
        out[key].update(ranks=[r[key] for r in ranks], init=params, jgrads=jgrads, batches=batches,
                        ckpt_dir=str(tmp / "ckpt" / key))
    return out


@pytest.mark.parametrize("key", list(SPECS))
def test_moe_trains_tensor_parallel(run, key):
    """Every rank's metrics at each step and every parameter after the last
    against the JAX Trainer under the same spec."""
    r = run(key)
    want = r["want"]
    assert (want[:, 1] > 0).all()  # the router terms count
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["metrics"], want, rtol=RTOL)
    final = r["ranks"][0]["final"]
    assert sorted(final) == sorted(r["jparams"])
    atol = PARAM_ATOL_BATCH_SPLIT if SPECS[key].get("fsdp", 1) > 1 else PARAM_ATOL
    for name, w in r["jparams"].items():
        np.testing.assert_allclose(final[name], w, rtol=0, atol=atol, err_msg=name)
        assert not np.array_equal(final[name], r["init"][name]) or name.endswith("scale")


@pytest.mark.parametrize("key", list(SPECS))
def test_tensor_ranks_route_alike_and_agree_on_replicated_grads(run, key):
    """The same dispatch on every tensor rank, and the router and norm
    gradients bit-equal across the tensor group and equal to JAX's: summed
    over ``tensor`` nowhere, they would be ``tp`` times too large."""
    r = run(key)
    for rank in r["ranks"]:
        assert rank["same_dispatch"] and rank["same_grads"]
        assert sorted(rank["grads"]) == sorted(n for n in r["jgrads"] if n.endswith(("router.weight", "scale")))
        for name, g in rank["grads"].items():
            want = r["jgrads"][name]
            np.testing.assert_allclose(g, want, rtol=0, atol=RTOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("key", list(SPECS))
def test_checkpoints_restore_and_resume(run, key):
    """``fit(resume="auto")`` from the step-2 checkpoint takes step 3 alone
    and ends on the uninterrupted loss."""
    r = run(key)
    for rank in r["ranks"]:
        resumed_from, end, loss = rank["resumed"]
        assert (resumed_from, end) == (STEPS - 1, STEPS)
        assert loss == pytest.approx(rank["metrics"][-1][0], rel=RTOL)


def test_tp_checkpoint_restores_on_one_device(run):
    """The tp=2 checkpoint is the one-device format, each expert's hidden
    columns whole: a one-device trainer restores it and takes step 3 to the
    same loss and router terms."""
    r = run("tp2")
    trainer = Trainer(MoEDecoder(_cfg(), device="meta"), adamw(LR), device="cpu")
    state = trainer.make_state(0, r["batches"][0], params={k: torch.from_numpy(v) for k, v in r["init"].items()})
    ckpt = Checkpointer(f"{r['ckpt_dir']}/steps")
    assert ckpt.saved_meta()["mesh_axes"] == {"tensor": 2}
    assert ckpt.restore_params()["layers.0.moe.w_down"].shape == (4, 96, 64)
    state = ckpt.restore(state)
    assert state.step == STEPS - 1
    _, m = trainer.step(state, r["batches"][STEPS])
    assert float(m["loss"]) == pytest.approx(r["want"][-1][0], rel=RTOL)
    assert float(m["aux_loss"]) == pytest.approx(r["want"][-1][1], rel=RTOL)
