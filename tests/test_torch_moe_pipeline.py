"""The port's MoE decoder in pipeline stages on gloo ranks against the JAX
package's pipelined Trainer: ``pp=2 x dp=2``, ``pp=2 x ep=2``, ``pp=2 x
tp=2`` and ``pp=2 x tp=2 x ep=2``.

One ``torch.multiprocessing`` spawn of four gloo ranks runs the first three
specs in turn, then restores ``pp=2 x ep=2``'s checkpoint onto ``ep=2 x
tp=2``; one spawn of eight runs the three-way spec (the runner of
``tests/test_torch_trainer_pipeline.py``: a file rendezvous, every wait
under ``TIMEOUT_S``, ``OMP_NUM_THREADS=1``). Each spec:
``TrainContext.create(spec, device="cpu")``, ``MoEConfig.tiny_moe`` in fp32
(two layers, one a stage, ``group_size`` 32) from the JAX ``make_state``
weights (converted from JAX's stage-stacked tree by
``convert.decoder_stage_params_from_flax``), two microbatches, three AdamW
steps (foreach, as on a card) on packed batches with a ``loss_mask``. The
JAX runs are cached per module.

* The counterparts of JAX's five pipelined MoE tests
  (``tests/test_trainer_pipeline.py``: the router aux under pp, pp x tp, pp
  x ep, the dense model refused under pp x ep, pp x tp x ep): every rank's
  loss, aux loss, total loss and grad norm at each step within 2e-5
  relative of JAX's pipelined Trainer under the same spec, every parameter
  after the last step within 2e-5 absolute; and the first step against the
  port's dense one-device Trainer on the same weights within JAX's own
  bounds (loss 2e-3, aux loss 1e-3, total 3e-3: a pipeline's router
  statistics are each microbatch's, a rank's rows alone, as in JAX).
* Each parameter of a stage on the mesh axes JAX's stage tree puts it,
  apart from the stated divergences (``wk``/``wv`` over ``tensor``; the
  embedding and the head held by their own stage alone).
* Every tensor rank routes alike and holds the same router and norm
  gradients.
* States move: JAX's pipelined MoE state one step in (parameters and AdamW
  moments, ``convert.adamw_state_from_optax``) adopted by the port's; the
  ``pp=2 x ep=2`` checkpoint (the one-device format) resumed by
  ``fit(resume="auto")``, restored onto ``ep=2 x tp=2`` and on one device;
  ``pp=2 x tp=2``'s on one device; ``evaluate`` through the stages and
  ``eval_logits`` through the gathered ``MoEDecoder``.
* ``lagom(train_fn, DistributedConfig(sharding=ShardingSpec(pp=2, ep=2)))``
  trains to JAX's loss.
"""

import functools
import json
import re
import threading
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from test_torch_moe_tp import record_routes, replicated_grads, same_over_tensor
from test_torch_trainer_pipeline import packed_batches

from maggy_tpu_torch.models import Decoder, DecoderConfig, MoEConfig, MoEDecoder
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.parallel.sharding import placed_mesh_axes
from maggy_tpu_torch.train import Checkpointer, TrainContext, Trainer, adamw
from maggy_tpu_torch.train.pipeline_adapter import decoder_pipeline_parts, stage_state

TIMEOUT_S = 150
LR = 5e-3
OPTIMIZER = functools.partial(adamw(LR), foreach=True)
STEPS = 3
B, S = 8, 32
GROUP = 32
N_MICRO = 2
RTOL = 2e-5
PARAM_ATOL = 2e-5
# JAX's own bounds for a pipelined MoE step against the dense one
DENSE_LOSS_ATOL, DENSE_AUX_ATOL, DENSE_TOTAL_ATOL = 2e-3, 1e-3, 3e-3
SPECS = {"pp2_dp2": dict(pp=2, dp=2), "pp2_ep2": dict(pp=2, ep=2), "pp2_tp2": dict(pp=2, tp=2),
         "pp2_tp2_ep2": dict(pp=2, tp=2, ep=2)}
WORLDS = {4: ("pp2_dp2", "pp2_ep2", "pp2_tp2"), 8: ("pp2_tp2_ep2",)}
METRICS = ("loss", "aux_loss", "grad_norm", "total_loss")


def _cfg():
    return MoEConfig.tiny_moe(dtype=torch.float32, group_size=GROUP)


def _rank(rank, n, init_file, out, args):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
        res = {key: _spec_body(key, **args) for key in WORLDS[n]}
        if n == 4:
            res["ep2_tp2_restored"] = _restore_onto_ep2_tp2(**args)
        out.put((rank, res))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _spec_body(key, init, batches, eval_batch, jax_state1, ckpt_root):
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    ctx = TrainContext.create(ShardingSpec(**SPECS[key]), device="cpu")

    def fresh():
        trainer = ctx.trainer(MoEDecoder(_cfg(), device="meta"), OPTIMIZER, n_microbatches=N_MICRO)
        return trainer, trainer.make_state(0, batches[0], params=init)

    tr, st = fresh()
    pipe = st.pipeline
    r = dict(stage=pipe.stage, data=ctx.mesh.get_local_rank("data"), leader=pipe.leader,
             stage_has_aux=pipe.parts.stage_has_aux, shardings=tr.state_shardings_for(batches[0]),
             axes={name: sorted(placed_mesh_axes(p)) for name, p in st.model.named_parameters()},
             experts=int(st.model.layers[str(pipe.stage)].moe.w_gate.shape[0]))
    routes, hooks = record_routes(st.model)
    ckpt = Checkpointer(f"{ckpt_root}/{key}", async_save=False) if key in ("pp2_ep2", "pp2_tp2") else None
    metrics = []
    for i, b in enumerate(batches[1:]):
        if ckpt is not None and i == STEPS - 1:
            ckpt.save(st.step, st, meta=tr.checkpoint_meta())
        st, m = tr.step(st, ctx.shard_batch(b))
        metrics.append([float(m[k]) for k in METRICS])
        if i == 0:
            for hook in hooks:
                hook.remove()
            if SPECS[key].get("tp", 1) > 1:
                r["same_dispatch"] = len(routes) > 0 and same_over_tensor(ctx, routes)
                r["same_grads"] = same_over_tensor(ctx, replicated_grads(st.model))
    if ckpt is not None:
        ckpt.close()
    final = stage_state(st)["params"]
    r.update(metrics=metrics, final={k: v.numpy() for k, v in final.items()} if pipe.leader else None)
    if key != "pp2_ep2":
        return r
    # evaluation: the forward sweep through the stages, and the logits of
    # the MoEDecoder gathered from every stage (the experts over `expert`)
    r["evaluate"] = tr.evaluate(st, iter([eval_batch] * 2), 2)["loss"]
    r["eval_logits"] = tr.eval_logits(st, eval_batch).numpy()
    # fit(resume="auto") from the step-2 checkpoint takes step 3 alone
    tr2, st2 = fresh()
    ck = Checkpointer(f"{ckpt_root}/{key}", async_save=False)
    st2, fit_out = tr2.fit(st2, iter(batches[1:]), STEPS, checkpointer=ck, resume="auto", prefetch=0)
    ck.close()
    r["fit_resumed"] = (fit_out.get("resumed_from"), st2.step, fit_out["loss"])
    # JAX's pipelined state one step in (parameters and AdamW moments), adopted
    tr3, _ = fresh()
    adopted = tr3.adopt_state(jax_state1, batches[0])
    r["jax_adopted"] = (adopted.step, float(tr3.step(adopted, ctx.shard_batch(batches[2]))[1]["loss"]))
    return r


def _restore_onto_ep2_tp2(init, batches, ckpt_root, **_):
    """``pp=2 x ep=2``'s step-2 checkpoint restored onto ``ep=2 x tp=2``,
    then step 3."""
    ctx = TrainContext.create(ShardingSpec(ep=2, tp=2), device="cpu")
    tr = ctx.trainer(MoEDecoder(_cfg(), device="meta"), OPTIMIZER)
    st = tr.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in init.items()})
    st = Checkpointer(f"{ckpt_root}/pp2_ep2").restore(st)
    step = st.step
    _, m = tr.step(st, ctx.shard_batch(batches[STEPS]))
    return dict(step=step, loss=float(m["loss"]), aux_loss=float(m["aux_loss"]))


def _run_ranks(n, args, tmp):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, str(tmp / f"rendezvous{n}"), out, args)) for r in range(n)]
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


def _jax_side(batches):
    """Per spec: JAX's pipelined Trainer from ``make_state``'s weights over
    the batches (its metrics, final parameters as the port's state dict,
    the mesh axes of each stage leaf), and pp=2 x ep=2's state one step in
    as a port pipeline state."""
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import MoEConfig as JConfig
    from maggy_tpu.models import MoEDecoder as JMoE
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch import convert

    jcfg = JConfig.tiny_moe(dtype=jnp.float32, group_size=GROUP)
    out = {}
    for key, kw in SPECS.items():
        spec = JShardingSpec(**kw)
        jctx = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices])
        jtr = jctx.trainer(JMoE(jcfg), optax.adamw(LR), n_microbatches=N_MICRO)
        jstate = jtr.make_state(jax.random.key(0), batches[0])
        assert jtr._pipeline_parts().stage_has_aux

        def canonical(state):
            stages = convert.decoder_stage_params_from_flax(jax.device_get(state.params), _cfg(), 2)
            return {k: v.numpy() for part in stages for k, v in part.items()}

        extent = dict(jctx.mesh.shape)
        axes = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
            name = ".".join(k.key for k in path).replace(".layer.", ".").replace(".kernel", ".weight")
            axes[name] = sorted({a for entry in leaf.sharding.spec
                                 for a in (entry if isinstance(entry, tuple) else (entry,))
                                 if a is not None and extent[a] > 1})
        r = {"init": canonical(jstate), "metrics": [], "axes": axes}
        for i, b in enumerate(batches[1:]):
            jstate, jm = jtr.step(jstate, jtr.shard_batch(b))
            r["metrics"].append([float(jm[k]) for k in METRICS])
            if i == 0 and key == "pp2_ep2":
                host = jax.device_get(jstate)
                r["state1"] = {
                    "step": 1,
                    "params": convert.decoder_stage_params_from_flax(host.params, _cfg(), 2),
                    "optimizer": convert.adamw_state_from_optax(host.opt_state, _cfg(), n_stages=2),
                    "hyper": None,
                }
        r["final"] = canonical(jstate)
        out[key] = r
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mp_env = pytest.MonkeyPatch()
    mp_env.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks inherit it
    batches = packed_batches(_cfg().vocab_size, STEPS + 1)
    eval_batch = packed_batches(_cfg().vocab_size, 1, seed=9)[0]
    jax_side = _jax_side(batches)
    init = jax_side["pp2_dp2"]["init"]
    for key in SPECS:  # one set of weights for every spec
        for name, v in jax_side[key]["init"].items():
            np.testing.assert_array_equal(v, init[name])
    dense = Trainer(MoEDecoder(_cfg(), device="meta"), OPTIMIZER, device="cpu")
    dstate = dense.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in init.items()})
    state1 = dict(jax_side["pp2_ep2"]["state1"])
    # the port's AdamW hyperparameters come with the JAX state it adopts
    state1["hyper"] = {k: v for k, v in dstate.optimizer.param_groups[0].items() if k != "params"}
    dense_first = [float(v) for v in (lambda m: [m[k] for k in METRICS])(dense.step(dstate, batches[1])[1])]
    tmp = tmp_path_factory.mktemp("moe_pipeline")
    args = dict(init=init, batches=batches, eval_batch=eval_batch, jax_state1=state1, ckpt_root=str(tmp / "ckpt"))
    ranks = {n: _run_ranks(n, args, tmp) for n in WORLDS}
    yield dict(jax=jax_side, ranks=ranks, batches=batches, eval_batch=eval_batch, init=init,
               dense_first=dense_first, ckpt_root=args["ckpt_root"])
    mp_env.undo()


def _ranks_of(run, key):
    return next(rs for n, rs in run["ranks"].items() if key in WORLDS[n])


def _merged_final(ranks, key):
    out = {}
    for r in ranks:
        if r[key]["final"] is not None:
            out.update(r[key]["final"])
    return out


def _check_against_jax(run, key):
    j = run["jax"][key]
    ranks = _ranks_of(run, key)
    assert (np.array(j["metrics"])[:, 1] > 0).all()  # the router terms count
    for r in ranks:
        assert r[key]["stage_has_aux"]
        np.testing.assert_allclose(r[key]["metrics"], j["metrics"], rtol=RTOL)
        np.testing.assert_allclose(r[key]["metrics"][0][3], r[key]["metrics"][0][0] + r[key]["metrics"][0][1],
                                   rtol=1e-6)
        loss, aux, _, total = r[key]["metrics"][0]
        d_loss, d_aux, _, d_total = run["dense_first"]
        assert abs(loss - d_loss) < DENSE_LOSS_ATOL and abs(aux - d_aux) < DENSE_AUX_ATOL
        assert abs(total - d_total) < DENSE_TOTAL_ATOL
        assert r[key]["experts"] == 4 // SPECS[key].get("ep", 1)
    final = _merged_final(ranks, key)
    assert list(final) == list(j["final"])  # every parameter, in the MoEDecoder's order
    for name, want in j["final"].items():
        np.testing.assert_allclose(final[name], want, rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert not np.array_equal(final[name], run["init"][name]) or name.endswith("scale")


def test_pp_moe_decoder_trains_with_router_aux(run):
    """pp=2 x dp=2: the stages' router terms join the objective at each
    stage's backward tick; the metrics are JAX's (``aux_loss`` the sum over
    stages of each microbatch's mean, ``total_loss = loss + aux_loss``)."""
    _check_against_jax(run, "pp2_dp2")


def test_pp_tp_moe_trains(run):
    """pp=2 x tp=2: the expert FFNs' hidden width over ``tensor`` inside
    each stage, the router terms per stage; every tensor rank routes alike
    and holds the same router and norm gradients."""
    _check_against_jax(run, "pp2_tp2")
    for r in _ranks_of(run, "pp2_tp2"):
        assert r["pp2_tp2"]["same_dispatch"] and r["pp2_tp2"]["same_grads"]


def test_pp_ep_moe_matches_dense(run):
    """pp=2 x ep=2: each stage's experts over ``expert``."""
    _check_against_jax(run, "pp2_ep2")


def test_pp_tp_ep_three_way_composition(run):
    """pp=2 x tp=2 x ep=2 on eight ranks: attention heads and expert
    hidden columns over ``tensor``, experts over ``expert``, in each
    stage."""
    _check_against_jax(run, "pp2_tp2_ep2")
    for r in _ranks_of(run, "pp2_tp2_ep2"):
        assert r["pp2_tp2_ep2"]["same_dispatch"] and r["pp2_tp2_ep2"]["same_grads"]


def test_pp_ep_dense_model_refused():
    """ep under pp with a dense model raises JAX's refusal; an MoE model's
    parts carry its router terms."""
    import jax.numpy as jnp

    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.models import MoEConfig as JMoEConfig
    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import MoEDecoder as JMoE
    from maggy_tpu.train.pipeline_adapter import decoder_pipeline_parts as jparts

    for parts in (decoder_pipeline_parts, jparts):
        model = Decoder(DecoderConfig.tiny(), device="meta") if parts is decoder_pipeline_parts else JDecoder(
            JConfig.tiny())
        with pytest.raises(ValueError, match="needs an MoE model"):
            parts(model, 2, ep=2)
    assert decoder_pipeline_parts(MoEDecoder(_cfg(), device="meta"), 2, ep=2).stage_has_aux
    assert jparts(JMoE(JMoEConfig.tiny_moe(dtype=jnp.float32)), 2).stage_has_aux
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        decoder_pipeline_parts(MoEDecoder(_cfg(), device="meta"), 2, ep=3)


def test_pp_moe_restack_round_trip_and_stage_draws():
    """``restack``/``unstack`` round-trip an MoEDecoder state dict at 1 and
    2 stages; each stage's seeded draws are the MoEDecoder's own weights
    (the experts drawn after every projection, as its ``reset_parameters``
    draws them)."""
    model = MoEDecoder(_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
    sd = dict(model.named_parameters())
    for n in (1, 2):
        parts = decoder_pipeline_parts(model, n)
        back = parts.unstack(parts.restack(sd))
        assert list(back) == list(sd) and all(back[k] is sd[k] for k in sd)
        assert parts.stage_of("layers.1.moe.w_down") == n - 1
        for s, names in enumerate(parts.stage_names):
            st = parts.make_stage(s, "cpu")
            st.reset_parameters(torch.Generator().manual_seed(0))
            for name, p in st.named_parameters():
                assert name in names and torch.equal(p, sd[name]), name


@pytest.mark.parametrize("key", list(SPECS))
def test_pp_moe_stage_layout_matches_jax(run, key):
    """Each rank's stage parameters on JAX's mesh axes for the same leaf of
    its stage tree (stage, and ``expert``/``tensor`` as its rules put them),
    apart from ``wk``/``wv`` over ``tensor``; ``state_shardings_for``
    agrees; the embedding lives on stage 0 and the head on the last."""
    want = run["jax"][key]["axes"]
    tp = SPECS[key].get("tp", 1)
    for r in _ranks_of(run, key):
        got = r[key]
        assert ("embedding" in got["axes"]) == (got["stage"] == 0)
        assert ("lm_head.weight" in got["axes"]) == (got["stage"] == 1)
        for name, axes in got["axes"].items():
            allowed = set(want[re.sub(r"layers\.\d+\.", "layers.", name)]) - {"stage"}
            if tp > 1 and re.search(r"attn\.w[kv]\.", name):
                allowed.add("tensor")  # the port's kv rule
            assert set(axes) == allowed, (name, axes, allowed)
            assert {a for dim in got["shardings"][name] if dim for a in dim} == allowed, name


def test_pp_moe_states_move(run):
    """JAX's pipelined MoE state one step in, adopted, takes JAX's second
    step; ``fit(resume="auto")`` from the pp=2 x ep=2 checkpoint takes step
    3 alone to the uninterrupted loss."""
    j = run["jax"]["pp2_ep2"]
    for r in _ranks_of(run, "pp2_ep2"):
        a = r["pp2_ep2"]
        assert a["jax_adopted"][0] == 1
        assert a["jax_adopted"][1] == pytest.approx(j["metrics"][1][0], rel=RTOL)
        resumed_from, end, loss = a["fit_resumed"]
        assert (resumed_from, end) == (STEPS - 1, STEPS)
        assert loss == pytest.approx(a["metrics"][-1][0], rel=RTOL)


def _one_device_restore(run, key):
    trainer = Trainer(MoEDecoder(_cfg(), device="meta"), OPTIMIZER, device="cpu")
    state = trainer.make_state(0, run["batches"][0])
    ckpt = Checkpointer(f"{run['ckpt_root']}/{key}")
    assert ckpt.saved_meta()["mesh_axes"] == {"stage": 2, **{
        {"ep": "expert", "tp": "tensor"}[k]: v for k, v in SPECS[key].items() if k != "pp"}}
    assert ckpt.restore_params()["layers.1.moe.w_gate"].shape == (4, 64, 96)  # every expert whole
    with pytest.warns(UserWarning, match="mesh_axes"):
        state = ckpt.restore(state, expect_meta=trainer.checkpoint_meta())
    assert state.step == STEPS - 1
    _, m = trainer.step(state, run["batches"][STEPS])
    return float(m["loss"]), float(m["aux_loss"])


@pytest.mark.parametrize("key", ["pp2_ep2", "pp2_tp2"])
def test_pp_moe_checkpoint_restores_on_one_device(run, key):
    """The pp x ep and pp x tp checkpoints are the one-device format (every
    expert and its hidden columns whole): a one-device trainer restores it
    and step 3 gives the pipeline's loss (whose router statistics alone are
    per microbatch)."""
    loss, _ = _one_device_restore(run, key)
    for r in _ranks_of(run, key):
        assert loss == pytest.approx(r[key]["metrics"][-1][0], rel=RTOL)


def test_pp_ep_checkpoint_restores_onto_ep_tp(run):
    """pp=2 x ep=2's checkpoint restored onto ep=2 x tp=2 (no stages: the
    router statistics over the whole batch) takes step 3 as the one-device
    trainer restoring it does."""
    loss, aux = _one_device_restore(run, "pp2_ep2")
    for r in run["ranks"][4]:
        got = r["ep2_tp2_restored"]
        assert got["step"] == STEPS - 1
        assert got["loss"] == pytest.approx(loss, rel=RTOL)
        assert got["aux_loss"] == pytest.approx(aux, rel=RTOL)


def test_pp_moe_evaluate_and_eval_logits(run):
    """``evaluate`` through the stages and ``eval_logits`` through the
    gathered MoEDecoder (every expert) against the dense forward on the
    final weights."""
    from maggy_tpu_torch.train import lm_loss_fn

    final = _merged_final(_ranks_of(run, "pp2_ep2"), "pp2_ep2")
    model = MoEDecoder(_cfg(), device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in final.items()})
    b = {k: torch.from_numpy(v) for k, v in run["eval_batch"].items()}
    with torch.no_grad():
        logits = model(b["tokens"], b["positions"], b["segment_ids"])
        dense_loss = float(lm_loss_fn(logits, b))
    for r in _ranks_of(run, "pp2_ep2"):
        assert r["pp2_ep2"]["evaluate"] == pytest.approx(dense_loss, rel=RTOL)
        np.testing.assert_allclose(r["pp2_ep2"]["eval_logits"], logits.numpy(), rtol=0, atol=PARAM_ATOL)


def pp_ep_train(model, dataset, hparams, reporter, ctx):
    """lagom's train_fn: a pipelined trainer from the context (its spec is
    the config's), the shared weights, ``fit`` over the global batches."""
    trainer = ctx.trainer(model, OPTIMIZER, n_microbatches=N_MICRO)
    batches = dataset["batches"]
    init = {k: torch.from_numpy(v) for k, v in dataset["init"].items()}
    state = trainer.make_state(0, batches[0], params=init)
    state, metrics = trainer.fit(state, iter(batches[1:]), num_steps=STEPS, reporter=reporter, report_every=1)
    return {"metric": metrics["loss"], "loss": metrics["loss"], "aux_loss": metrics["aux_loss"],
            "mesh": dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)), "stage": state.pipeline.stage}


def test_lagom_distributed_config_pp2_ep2(run, tmp_path):
    """``lagom(train_fn, DistributedConfig(sharding=ShardingSpec(pp=2,
    ep=2)))``: four spawned gloo ranks end on JAX's pp=2 x ep=2 loss."""
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    want = run["jax"]["pp2_ep2"]["metrics"][-1]
    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    out = {}
    try:
        config = DistributedConfig(
            module=MoEDecoder(_cfg(), device="meta"), dataset={"batches": run["batches"], "init": run["init"]},
            sharding=ShardingSpec(pp=2, ep=2), num_executors=4, mixed_precision=False, hb_interval=0.1,
            device="cpu",
        )
        t = threading.Thread(target=lambda: out.update(result=experiment.lagom(pp_ep_train, config)), daemon=True)
        t.start()
        t.join(TIMEOUT_S)
        assert not t.is_alive(), f"lagom did not return within {TIMEOUT_S} s"
        ranks = [json.loads(p.read_text()) for p in sorted(Path(tmp_path / "torch").rglob(".outputs.json"))]
    finally:
        env_mod.set_instance(None)
    assert out["result"]["num_workers"] == 4
    assert out["result"]["loss"] == pytest.approx(want[0], rel=RTOL)
    assert sorted(r["stage"] for r in ranks) == [0, 0, 1, 1]
    for r in ranks:
        assert r["mesh"] == {"stage": 2, "data": 1, "fsdp": 1, "expert": 2, "seq": 1, "tensor": 1}
        assert r["loss"] == pytest.approx(want[0], rel=RTOL)
        assert r["aux_loss"] == pytest.approx(want[1], rel=RTOL)
