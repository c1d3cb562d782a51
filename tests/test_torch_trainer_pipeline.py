"""The port's pipelined Trainer (``pp > 1``) on gloo ranks against the JAX
package's pipelined Trainer.

One ``torch.multiprocessing`` spawn of four gloo ranks serves the module
(a file rendezvous, every wait under ``TIMEOUT_S``). In it each rank runs,
in turn, ``pp=2 x dp=2``, ``pp=4`` and ``pp=2 x tp=2`` over the same four
ranks: ``TrainContext.create(spec, device="cpu")``, a Decoder of 4 layers
(tiny widths, fp32) from the JAX ``make_state`` weights (converted from
JAX's stage-stacked tree by ``convert.decoder_stage_params_from_flax``),
three AdamW steps (its foreach kernels, as on a card) on packed batches
with a ``loss_mask``. The JAX side is its ``Trainer`` under the same spec
and ``n_microbatches`` on the conftest's CPU devices.

* Every rank's loss and grad norm at each step within 2e-5 relative of
  JAX's and of the port's dense one-device Trainer, and every parameter
  after the last step within 2e-5 absolute; uneven loss masks and uneven
  packing across microbatches give the dense global token-weighted mean.
* ``evaluate`` through the forward-only pipeline (never gathering the
  whole model) and ``eval_logits`` through the gathered Decoder, against
  the dense forward on the same weights.
* States move: a pp=2 state re-staged to pp=4 by
  ``convert_pipeline_state``; JAX's pp=2 state (parameters and AdamW
  moments, ``convert.adamw_state_from_optax``) adopted by the port's; a
  dense state adopted onto the pipeline; a pp=2 checkpoint restored onto
  pp=2, pp=4, pp=2 x tp=2 and one device; ``fit(resume="auto")`` under pp.
  Each then takes the uninterrupted run's next step.
* Every refusal of JAX's (not a Decoder, pp x sp, layers not divisible by
  the stages, tied embeddings, ablation gates, decode, heads tp does not
  divide, ep, microbatches that do not divide the rows), on torch's fake
  process group; ``zero_stage`` on a pp mesh warns once and runs dense.
* Two planted faults, a stage that drops the gradient hand-off of its last
  microbatch and a pp x dp rank that keeps its own gradient instead of the
  ``data`` all-reduce's, each fail ``chip_smoke.held_to_single``'s limits
  against the sound run, which passes them.
* ``lagom(train_fn, DistributedConfig(sharding=ShardingSpec(pp=2)))``
  trains to JAX's loss.
"""

import functools
import json
import math
import threading
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import ShardingSpec, make_mesh
from maggy_tpu_torch.train import Checkpointer, TrainContext, Trainer, adamw
from maggy_tpu_torch.train.pipeline_adapter import convert_pipeline_state, decoder_pipeline_parts

TIMEOUT_S = 150
WORLD = 4
LR = 5e-3
# the optimizer as it runs on a card, where AdamW defaults to its foreach
# kernels (the CPU defaults to the per-tensor loop)
OPTIMIZER = functools.partial(adamw(LR), foreach=True)
STEPS = 3
B, S = 8, 32
N_LAYERS = 4
RTOL = 2e-5
PARAM_ATOL = 2e-5
# spec key -> (ShardingSpec fields, n_microbatches)
SPECS = {"pp2_dp2": (dict(pp=2, dp=2), 2), "pp4": (dict(pp=4), 4), "pp2_tp2": (dict(pp=2, tp=2), 2)}


def tcfg():
    return DecoderConfig.tiny(dtype=torch.float32, n_layers=N_LAYERS)


def packed_batches(vocab: int, n: int, seed: int = 0):
    """``n`` packed batches: 1-3 segments per row (positions restart at
    each), and a loss mask that drops a random fifth of the targets."""
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


def uneven_batches(vocab: int):
    """JAX's two uneven batches: a loss mask dense in microbatch 0 and
    sparse elsewhere; four segments a row in rows 0-3, one in rows 4-7."""
    rng = np.random.default_rng(3)
    mask = np.zeros((B, S), np.float32)
    mask[:2] = 1
    mask[2:, :3] = 1
    masked = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32), "loss_mask": mask}
    seg = np.zeros((B, S), np.int32)
    for i, b in enumerate((8, 16, 24)):
        seg[:4, b:] = i + 1
    pos = np.stack([np.concatenate([np.arange(8)] * 4)] * 4 + [np.arange(S)] * 4).astype(np.int32)
    packed = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32), "positions": pos, "segment_ids": seg}
    return {"mask": masked, "packed": packed}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _figures(ctx, fresh, batches, groups_fn):
    """What ``chip_smoke.mesh_steps`` reads, on the CPU: a warm-up step
    (its gradient groups, gathered whole and over the stages, and how far
    the trainer's norm lies from theirs), then the other steps."""
    tr, st = fresh()
    st, m = tr.step(st, ctx.shard_batch(batches[1]))
    groups = groups_fn(st.model, st)
    whole = math.sqrt(sum(v * v for v in groups.values()))
    losses, first = [float(m["loss"])], float(m["grad_norm"])
    for b in batches[2:]:
        st, m = tr.step(st, ctx.shard_batch(b))
        losses.append(float(m["loss"]))
    return dict(losses=losses, first_grad_norm=first, last_grad_norm=float(m["grad_norm"]), group_grad_norms=groups,
                grad_norm_count_rel=_rel(first, whole), params_on_card=True, spec_s=0.0, step_ms=1.0,
                peak_gib=0.0, mesh={})


def _rank(rank, init_file, out, args):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
        out.put((rank, _rank_body(rank, **args)))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _rank_body(rank, init, batches, uneven, eval_batch, jax_state1, ckpt_a, ckpt_fit):
    import chip_smoke
    from maggy_tpu_torch.parallel import pipeline as pipeline_mod
    from maggy_tpu_torch.train import pipeline_adapter

    init = {k: torch.from_numpy(v) for k, v in init.items()}
    cfg = tcfg()
    res = {}
    stage_states = parts_a = None
    for key, (kw, n_micro) in SPECS.items():
        ctx = TrainContext.create(ShardingSpec(**kw), device="cpu")

        def fresh(n=n_micro):
            trainer = ctx.trainer(Decoder(cfg, device="meta"), OPTIMIZER, n_microbatches=n)
            return trainer, trainer.make_state(0, batches[0], params=init)

        tr, st = fresh()
        layout = st.pipeline
        r = dict(stage=layout.stage, data=ctx.mesh.get_local_rank("data"), leader=layout.leader,
                 meta=tr.checkpoint_meta(), shardings=tr.state_shardings_for(batches[0]),
                 dtensors=sorted(n for n, p in st.model.named_parameters() if hasattr(p, "full_tensor")))
        losses, norms, s1 = [], [], None
        ckpt = Checkpointer(ckpt_a, async_save=False) if key == "pp2_dp2" else None
        for i, b in enumerate(batches[1:]):
            if ckpt is not None and i == STEPS - 1:
                ckpt.save(st.step, st, meta=tr.checkpoint_meta())
            st, m = tr.step(st, ctx.shard_batch(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0 and key == "pp2_dp2":
                s1 = pipeline_adapter.stage_state(st)
        if ckpt is not None:
            ckpt.close()
        final = pipeline_adapter.stage_state(st)["params"]
        r.update(losses=losses, norms=norms, final={k: v.numpy() for k, v in final.items()} if layout.leader else None)
        # evaluation: the forward-only pipeline never gathers the whole model
        calls = []
        gather = tr.dense_model
        tr.dense_model = lambda state: calls.append(1) or gather(state)
        r["evaluate"] = tr.evaluate(st, iter([eval_batch] * 2), 2)["loss"]
        r["evaluate_gathered"] = len(calls)
        r["eval_logits"] = tr.eval_logits(st, eval_batch).numpy()
        # pp=2's checkpoint after step 2, restored into a fresh state on this mesh
        tr2, st2 = fresh()
        st2 = Checkpointer(ckpt_a).restore(st2, expect_meta=tr2.checkpoint_meta())
        r["restored_step"] = st2.step
        r["restored_loss"] = float(tr2.step(st2, ctx.shard_batch(batches[STEPS]))[1]["loss"])
        if key == "pp2_dp2":
            parts_a = tr._pipeline_parts()
            everyone = [None] * WORLD
            dist.all_gather_object(everyone, (layout.stage, layout.leader, s1))
            mine = {s: part for s, lead, part in everyone if lead}
            stage_states = {"step": 1, "params": [mine[s]["params"] for s in range(2)],
                            "optimizer": [mine[s]["optimizer"] for s in range(2)], "hyper": mine[0]["hyper"]}
            # JAX's pp=2 state one step in (parameters and AdamW moments), adopted
            adopted = tr.adopt_state(jax_state1, batches[0])
            r["jax_adopted_step"] = adopted.step
            r["jax_adopted_loss"] = float(tr.step(adopted, ctx.shard_batch(batches[2]))[1]["loss"])
            # a dense one-device state one step in, adopted
            dense = Trainer(Decoder(cfg, device="meta"), adamw(LR), device="cpu")
            dstate = dense.make_state(0, batches[0], params=init)
            dense.step(dstate, batches[1])
            adopted = tr.adopt_state(dstate, batches[0])
            r["dense_adopted_loss"] = float(tr.step(adopted, ctx.shard_batch(batches[2]))[1]["loss"])
            r["dense_loss"] = float(dense.step(dstate, batches[2])[1]["loss"])
            # uneven masks and packing across microbatches, from the same weights
            for name, b in uneven.items():
                tr3, st3 = fresh()
                r[f"uneven_{name}"] = float(tr3.step(st3, ctx.shard_batch(b))[1]["loss"])
            # four microbatches instead of two: the same step
            tr3, st3 = fresh(4)
            r["micro4_loss"] = float(tr3.step(st3, ctx.shard_batch(batches[1]))[1]["loss"])
            # fit under pp: 2 steps checkpointed, then resume="auto" to 3
            tr3, st3 = fresh()
            tr3.fit(st3, iter(batches[1:]), 2, checkpointer=Checkpointer(ckpt_fit, async_save=False),
                    checkpoint_every=2)
            tr3, st3 = fresh()
            ck = Checkpointer(ckpt_fit)
            st3, fit_out = tr3.fit(st3, iter(batches[1:]), STEPS, checkpointer=ck, resume="auto")
            ck.close()
            r["fit_resumed"] = (fit_out.get("resumed_from"), fit_out["loss"], st3.step)
            # the planted faults, each against the sound run
            r["sound"] = _figures(ctx, fresh, batches, chip_smoke.grad_norms_by_group)
            sends = [0]
            exchange = pipeline_mod._exchange

            def drop_last_grad(send, recv):  # each step's M-th gradient hand-off goes out as zeros
                for i, (t, peer, tag) in enumerate(send):
                    if tag == pipeline_mod.GRAD_TAG:
                        sends[0] += 1
                        if sends[0] % n_micro == 0:
                            send[i] = (torch.zeros_like(t), peer, tag)
                exchange(send, recv)

            pipeline_mod._exchange = drop_last_grad
            try:
                r["drop_grad_handoff"] = _figures(ctx, fresh, batches, chip_smoke.grad_norms_by_group)
            finally:
                pipeline_mod._exchange = exchange
            summed = pipeline_mod._Topology.sum_over_batch

            def keep_own(self, tensors):  # rank 0 sends its gradient but keeps its own
                if dist.get_rank() == 0:
                    return summed(self, [t.clone() for t in tensors])
                return summed(self, tensors)

            pipeline_mod._Topology.sum_over_batch = keep_own
            try:
                r["skip_data_all_reduce"] = _figures(ctx, fresh, batches, chip_smoke.grad_norms_by_group)
            finally:
                pipeline_mod._Topology.sum_over_batch = summed
        if key == "pp4":  # pp=2's state one step in, re-staged to pp=4
            converted = convert_pipeline_state(stage_states, parts_a, tr._pipeline_parts())
            r["converted_embedding"] = converted["params"][0]["embedding"].numpy() if layout.stage == 0 else None
            adopted = tr.adopt_state(converted, batches[0])
            r["converted_loss"] = float(tr.step(adopted, ctx.shard_batch(batches[2]))[1]["loss"])
        res[key] = r
        assert pipeline_adapter._overlap_fallback_warned is False  # no overlap knob was asked for
    return res


def _run_ranks(args, tmp):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "rendezvous"), out, args)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=TIMEOUT_S) for _ in range(WORLD)), key=lambda r: r[0])
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


def _jax_side(batches, uneven, eval_batch):
    """Per spec: JAX's pipelined Trainer from ``make_state``'s weights over
    the batches — its losses, grad norms, final parameters (as the port's
    state dict), its pipelined ``evaluate``; and its pp=2 state one step in,
    as a port pipeline state. Plus JAX's dense loss on the uneven batches."""
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch import convert

    jcfg = JConfig.tiny(dtype=jnp.float32, n_layers=N_LAYERS)
    out = {}
    for key, (kw, n_micro) in SPECS.items():
        spec = JShardingSpec(**kw)
        jctx = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices])
        jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR), n_microbatches=n_micro)
        jstate = jtr.make_state(jax.random.key(0), batches[0])

        def canonical(state):
            stages = convert.decoder_stage_params_from_flax(jax.device_get(state.params), tcfg(), kw["pp"])
            return {k: v.numpy() for part in stages for k, v in part.items()}

        r = {"init": canonical(jstate), "losses": [], "norms": []}
        for i, b in enumerate(batches[1:]):
            jstate, jm = jtr.step(jstate, jtr.shard_batch(b))
            r["losses"].append(float(jm["loss"]))
            r["norms"].append(float(jm["grad_norm"]))
            if i == 0 and key == "pp2_dp2":
                host = jax.device_get(jstate)
                r["state1"] = {
                    "step": 1,
                    "params": convert.decoder_stage_params_from_flax(host.params, tcfg(), 2),
                    "optimizer": convert.adamw_state_from_optax(host.opt_state, tcfg(), n_stages=2),
                    "hyper": None,
                }
        r["final"] = canonical(jstate)
        r["evaluate"] = jtr.evaluate(jstate, iter([eval_batch] * 2), 2)["loss"]
        if key == "pp2_dp2":  # JAX's pipelined step from the same weights equals its dense loss (its tests)
            r["uneven"] = {name: float(jtr.step(jtr.make_state(jax.random.key(0), batches[0]),
                                                jtr.shard_batch(b))[1]["loss"]) for name, b in uneven.items()}
        out[key] = r
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from maggy_tpu.models import DecoderConfig as JConfig

    vocab = JConfig.tiny().vocab_size
    batches = packed_batches(vocab, STEPS + 1)
    uneven = uneven_batches(vocab)
    eval_batch = packed_batches(vocab, 1, seed=9)[0]
    jax_side = _jax_side(batches, uneven, eval_batch)
    init = jax_side["pp2_dp2"]["init"]
    for key in SPECS:  # one set of weights, whatever the stage count
        for name, v in jax_side[key]["init"].items():
            np.testing.assert_array_equal(v, init[name])
    state1 = dict(jax_side["pp2_dp2"]["state1"])
    # the port's AdamW hyperparameters come with the JAX state it adopts
    state1["hyper"] = {k: v for k, v in Trainer(Decoder(tcfg(), device="meta"), OPTIMIZER, device="cpu")
                       .make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in init.items()})
                       .optimizer.param_groups[0].items() if k != "params"}
    tmp = tmp_path_factory.mktemp("trainer_pipeline")
    args = dict(init=init, batches=batches, uneven=uneven, eval_batch=eval_batch, jax_state1=state1,
                ckpt_a=str(tmp / "ckpt_a"), ckpt_fit=str(tmp / "ckpt_fit"))
    ranks = _run_ranks(args, tmp)
    dense = Trainer(Decoder(tcfg(), device="meta"), OPTIMIZER, device="cpu")
    dstate = dense.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in init.items()})
    dense_losses = [float(dense.step(dstate, b)[1]["loss"]) for b in batches[1:]]
    return dict(jax=jax_side, ranks=ranks, batches=batches, eval_batch=eval_batch, init=init,
                dense_losses=dense_losses, ckpt_a=args["ckpt_a"])


def _merged_final(ranks, key):
    out = {}
    for r in ranks:
        if r[key]["final"] is not None:
            out.update(r[key]["final"])
    return out


def _dense_model(params):
    model = Decoder(tcfg(), device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    return model


@pytest.mark.parametrize("key", list(SPECS))
def test_pp_trainer_matches_jax_pp_trainer(run, key):
    """Losses and grad norms on every rank, and every parameter after three
    steps, against JAX's pipelined Trainer under the same spec."""
    j = run["jax"][key]
    for r in run["ranks"]:
        np.testing.assert_allclose(r[key]["losses"], j["losses"], rtol=RTOL)
        np.testing.assert_allclose(r[key]["norms"], j["norms"], rtol=RTOL)
        kw, n_micro = SPECS[key]
        assert r[key]["meta"]["mesh_axes"] == {
            {"pp": "stage", "dp": "data", "tp": "tensor"}[k]: v for k, v in kw.items()}
        assert r[key]["meta"]["n_microbatches"] == n_micro
    final = _merged_final(run["ranks"], key)
    assert list(final) == list(j["final"])  # every parameter, in the Decoder's order
    for name, want in j["final"].items():
        np.testing.assert_allclose(final[name], want, rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert not np.array_equal(final[name], run["init"][name]) or name.endswith("scale")


@pytest.mark.parametrize("key", list(SPECS))
def test_pp_trainer_matches_the_dense_trainer(run, key):
    """The pipeline's loss is the dense one-device Trainer's global
    token-weighted mean on the same packed, masked batches."""
    for r in run["ranks"]:
        np.testing.assert_allclose(r[key]["losses"], run["dense_losses"], rtol=RTOL)


def test_pp_stage_layout(run):
    """Each rank holds its stage: the embedding on stage 0 only, the head
    on the last only, parameters replicated over data (no FSDP2), and under
    tp the DTensor rules (heads, MLP width, vocabulary over ``tensor``)."""
    parts = decoder_pipeline_parts(Decoder(tcfg(), device="meta"), 2)
    for r in run["ranks"]:
        a, c = r["pp2_dp2"], r["pp2_tp2"]
        assert sorted(a["shardings"]) == sorted(parts.stage_names[a["stage"]])
        assert all(dims == (None,) * len(dims) for dims in a["shardings"].values()) and a["dtensors"] == []
        assert ("embedding" in a["shardings"]) == (a["stage"] == 0)
        assert ("lm_head.weight" in a["shardings"]) == (a["stage"] == 1)
        assert sorted(c["dtensors"]) == sorted(parts.stage_names[c["stage"]])
        wq = next(k for k in c["shardings"] if k.endswith("attn.wq.weight"))
        assert c["shardings"][wq][0] == ("tensor",)
        if c["stage"] == 1:
            assert c["shardings"]["lm_head.weight"][0] == ("tensor",)


def test_pp_uneven_mask_and_packing_match_dense_weighting(run):
    """A loss mask dense in one microbatch and sparse in the other, and
    uneven packing: the step reports the dense global masked mean (JAX's
    dense loss on the same weights), not a mean of microbatch means."""
    for r in run["ranks"]:
        for name in ("mask", "packed"):
            assert r["pp2_dp2"][f"uneven_{name}"] == pytest.approx(run["jax"]["pp2_dp2"]["uneven"][name], rel=RTOL)


@pytest.mark.parametrize("key", list(SPECS))
def test_pp_evaluate_and_eval_logits(run, key):
    """``evaluate`` runs the forward-only pipeline (no rank gathers the
    model) and equals JAX's pipelined evaluate and the dense loss on the
    same weights; ``eval_logits`` (each rank's rows, through the gathered
    Decoder) equals the dense forward."""
    from maggy_tpu_torch.train import lm_loss_fn

    final = _merged_final(run["ranks"], key)
    model = _dense_model(final)
    b = {k: torch.from_numpy(v) for k, v in run["eval_batch"].items()}
    with torch.no_grad():
        logits = model(b["tokens"], b["positions"], b["segment_ids"])
        dense_loss = float(lm_loss_fn(logits, b))
    dp = SPECS[key][0].get("dp", 1)
    for r in run["ranks"]:
        res = r[key]
        assert res["evaluate_gathered"] == 0
        assert res["evaluate"] == pytest.approx(dense_loss, rel=RTOL)
        assert res["evaluate"] == pytest.approx(run["jax"][key]["evaluate"], rel=RTOL)
        rows = slice(res["data"] * B // dp, (res["data"] + 1) * B // dp)
        np.testing.assert_allclose(res["eval_logits"], logits[rows].numpy(), rtol=0, atol=PARAM_ATOL)


def test_pp_restack_round_trip_and_refused_layouts():
    """``restack``/``unstack`` round-trip a Decoder state dict at 2 and 4
    stages; each stage holds its layers, stage 0 the embedding and the last
    the head; ``stage_of`` names the owner."""
    model = Decoder(tcfg(), device="cpu", generator=torch.Generator().manual_seed(0))
    sd = dict(model.named_parameters())
    for n in (1, 2, 4):
        parts = decoder_pipeline_parts(model, n)
        stages = parts.restack(sd)
        assert len(stages) == n and parts.layers_per_stage == N_LAYERS // n
        back = parts.unstack(stages)
        assert list(back) == list(sd) and all(back[k] is sd[k] for k in sd)
        assert parts.stage_of("embedding") == 0 and parts.stage_of("lm_head.weight") == n - 1
        assert parts.stage_of(f"layers.{N_LAYERS - 1}.attn.wq.weight") == n - 1
        for s, names in enumerate(parts.stage_names):
            st = parts.make_stage(s, "cpu")
            st.reset_parameters(torch.Generator().manual_seed(0))  # the Decoder's own draws
            for name, p in st.named_parameters():
                assert name in names and torch.equal(p, sd[name]), name


def test_convert_pipeline_state_across_pp_degrees(run):
    """A pp=2 state one step in (parameters and AdamW moments) re-staged to
    pp=4 and adopted takes pp=2's next step."""
    a = run["ranks"][0]["pp2_dp2"]
    for r in run["ranks"]:
        assert r["pp4"]["converted_loss"] == pytest.approx(a["losses"][1], rel=RTOL)
        if r["pp4"]["stage"] == 0:
            np.testing.assert_array_equal(r["pp4"]["converted_embedding"].shape, run["init"]["embedding"].shape)


def test_adopt_jax_and_dense_states_onto_the_pipeline(run):
    """JAX's pp=2 state one step in (``convert.decoder_stage_params_from_flax``,
    ``convert.adamw_state_from_optax``), adopted, takes JAX's second step;
    a dense one-device state one step in takes the dense trainer's."""
    for r in run["ranks"]:
        a = r["pp2_dp2"]
        assert a["jax_adopted_step"] == 1
        assert a["jax_adopted_loss"] == pytest.approx(run["jax"]["pp2_dp2"]["losses"][1], rel=RTOL)
        assert a["dense_adopted_loss"] == pytest.approx(a["dense_loss"], rel=RTOL)
        assert a["micro4_loss"] == pytest.approx(a["losses"][0], rel=RTOL)


@pytest.mark.parametrize("key", list(SPECS))
def test_pp_checkpoint_restores_onto_pp_layouts(run, key):
    """pp=2 x dp=2's checkpoint after step 2 restored onto pp=2 x dp=2,
    pp=4 and pp=2 x tp=2: the same step, and step 3 gives the uninterrupted
    loss."""
    want = run["ranks"][0]["pp2_dp2"]["losses"][-1]
    for r in run["ranks"]:
        assert r[key]["restored_step"] == STEPS - 1
        assert r[key]["restored_loss"] == pytest.approx(want, rel=RTOL)


def test_pp_checkpoint_restores_onto_one_device(run):
    """The pp checkpoint is the one-device format: a dense trainer restores
    it and continues the trajectory."""
    trainer = Trainer(Decoder(tcfg(), device="meta"), OPTIMIZER, device="cpu")
    state = trainer.make_state(0, run["batches"][0])
    ckpt = Checkpointer(run["ckpt_a"])
    assert ckpt.saved_meta()["mesh_axes"] == {"stage": 2, "data": 2}
    with pytest.warns(UserWarning, match="mesh_axes"):
        state = ckpt.restore(state, expect_meta=trainer.checkpoint_meta())
    assert state.step == STEPS - 1
    _, m = trainer.step(state, run["batches"][STEPS])
    assert float(m["loss"]) == pytest.approx(run["ranks"][0]["pp2_dp2"]["losses"][-1], rel=RTOL)
    assert float(m["grad_norm"]) == pytest.approx(run["jax"]["pp2_dp2"]["norms"][-1], rel=RTOL)


def test_fit_resume_auto_under_pp(run):
    for r in run["ranks"]:
        resumed_from, loss, step = r["pp2_dp2"]["fit_resumed"]
        assert resumed_from == 2.0 and step == STEPS
        assert loss == pytest.approx(r["pp2_dp2"]["losses"][-1], rel=RTOL)


@pytest.mark.parametrize("fault", ["drop_grad_handoff", "skip_data_all_reduce"])
def test_planted_faults_fail_dist_pipe_limits(run, fault):
    """``chip_smoke.held_to_single``'s limits, applied to a faulty run
    against the sound one: some rank fails them; the sound run, against
    itself and against a rerun of it, passes."""
    import chip_smoke

    sound = {r["pp2_dp2"]["stage"] * 10 + r["pp2_dp2"]["data"]: r["pp2_dp2"]["sound"] for r in run["ranks"]}
    faulty = [chip_smoke.held_to_single(r["pp2_dp2"][fault], sound[0]) for r in run["ranks"]]
    control = [chip_smoke.held_to_single(r["pp2_dp2"]["sound"], sound[0]) for r in run["ranks"]]
    assert all(c["ok"] for c in control), control
    assert not all(f["ok"] for f in faulty), faulty


def test_pp_raises_loudly_for_unsupported():
    """Every refusal of JAX's pipeline, as JAX raises it, over torch's fake
    process group (nothing is sent)."""
    import jax
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu.train.pipeline_adapter import decoder_pipeline_parts as jparts
    from torch.testing._internal.distributed.fake_pg import FakeStore

    batch = {"tokens": np.zeros((8, 32), np.int32)}

    def port(spec_kw, cfg=None, model=None, **kw):
        spec = ShardingSpec(**spec_kw)
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=spec.num_devices)
        mesh = make_mesh(spec, "cpu")
        model = model if model is not None else Decoder(cfg or DecoderConfig.tiny(), device="meta")
        return Trainer(model, adamw(1e-2), device="cpu", mesh=mesh, **kw)

    def jax_tr(spec_kw, cfg=None, model=None, **kw):
        spec = JShardingSpec(**spec_kw)
        ctx = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices])
        return ctx.trainer(model if model is not None else JDecoder(cfg or JConfig.tiny()), optax.sgd(1e-2), **kw)

    try:
        cases = [  # (port trainer, JAX trainer, sample batch, message)
            (lambda: port(dict(pp=2, dp=2), model=torch.nn.Linear(4, 4)), None, {"inputs": np.zeros((8, 4))},
             "Decoder"),
            (lambda: port(dict(pp=2, sp=2)), lambda: jax_tr(dict(pp=2, dp=2, sp=2)), batch,
             "does not compose with sp"),
            (lambda: port(dict(pp=4), DecoderConfig.tiny(n_layers=2)),
             lambda: jax_tr(dict(pp=4, dp=2), JConfig.tiny(n_layers=2)), batch, "divisible"),
            (lambda: port(dict(pp=2), DecoderConfig.tiny(tie_embeddings=True)),
             lambda: jax_tr(dict(pp=2, dp=4), JConfig.tiny(tie_embeddings=True)), batch, "tie_embeddings"),
            (lambda: port(dict(pp=2), DecoderConfig.tiny(ablated={"mlp"})),
             lambda: jax_tr(dict(pp=2, dp=4), JConfig.tiny(ablated=frozenset({"mlp"}))), batch, "ablated"),
            (lambda: port(dict(pp=2), DecoderConfig.tiny(decode=True)),
             lambda: jax_tr(dict(pp=2, dp=4), JConfig.tiny(decode=True)), batch, "decode"),
            (lambda: port(dict(pp=2, tp=4), DecoderConfig.tiny(n_kv_heads=2)), None, batch, "n_kv_heads"),
        ]
        for make_port, make_jax, sample, msg in cases:
            with pytest.raises(ValueError, match=msg):
                make_port().make_state(0, sample)
            if make_jax is not None:
                with pytest.raises(ValueError, match=msg):
                    make_jax().make_state(jax.random.key(0), sample)
        # ep under pp on a dense model: JAX's refusal; with an MoE model the
        # spec builds (tests/test_torch_moe_pipeline.py trains it)
        with pytest.raises(ValueError, match="needs an MoE model") as refused:
            decoder_pipeline_parts(Decoder(DecoderConfig.tiny(), device="meta"), 2, ep=2)
        assert "ROADMAP" not in str(refused.value)
        with pytest.raises(ValueError, match="needs an MoE model"):
            jparts(JDecoder(JConfig.tiny()), 2, ep=2)
        assert ShardingSpec(pp=2, ep=2).axis_sizes() == JShardingSpec(pp=2, ep=2).axis_sizes()
        # each microbatch's rows must split over data x fsdp: a clear error
        tr = port(dict(pp=2, dp=4), n_microbatches=4)
        state = tr.make_state(0, batch)  # 8 rows -> 2 a rank < 4 microbatches
        with pytest.raises(ValueError, match="microbatches"):
            tr.step(state, tr.shard_batch(batch))
        jtr = jax_tr(dict(pp=2, dp=4), n_microbatches=4)
        jstate = jtr.make_state(jax.random.key(0), batch)
        with pytest.raises(ValueError, match="microbatches"):
            jtr.step(jstate, jtr.shard_batch(batch))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_overlap_knobs_on_a_pp_mesh_warn_once_and_run_dense(monkeypatch):
    """``zero_stage``/``bucket_mb`` on a pp mesh: JAX's one-time warning,
    then the pipeline step (no bucketed or ZeRO-1 layout)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import pipeline_adapter as jadapter
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.train import pipeline_adapter

    import jax
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig

    monkeypatch.setattr(pipeline_adapter, "_overlap_fallback_warned", False)
    monkeypatch.setattr(jadapter, "_overlap_fallback_warned", False)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh(ShardingSpec(pp=2, dp=2), "cpu")
        tr = Trainer(Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), device="cpu", mesh=mesh,
                     zero_stage=1)
        with pytest.warns(UserWarning, match="pipeline mesh") as got:
            assert tr._overlap_mode() == ("off", (), 1)
        jctx = JTrainContext.create(JShardingSpec(pp=2, dp=2), devices=jax.devices()[:4])
        with pytest.warns(UserWarning, match="pipeline mesh") as ref:
            assert jctx.trainer(JDecoder(JConfig.tiny()), optax.sgd(1e-2), zero_stage=1)._overlap_mode()[0] == "off"
        assert str(got[0].message) == str(ref[0].message)
        state = tr.make_state(0, {"tokens": np.zeros((8, 32), np.int32)})
        assert state.layout is None and state.pipeline is not None
    finally:
        dist.destroy_process_group()


def pp_train(model, dataset, hparams, reporter, ctx):
    """lagom's train_fn: a pipelined trainer from the context (its spec is
    the config's), the shared weights, ``fit`` over the global batches."""
    trainer = ctx.trainer(model, adamw(hparams["lr"]), n_microbatches=2)
    batches = dataset["batches"]
    init = {k: torch.from_numpy(v) for k, v in dataset["init"].items()}
    state = trainer.make_state(0, batches[0], params=init)
    state, metrics = trainer.fit(state, iter(batches[1:]), num_steps=STEPS, reporter=reporter, report_every=1)
    return {"metric": metrics["loss"], "loss": metrics["loss"], "rank": ctx.process_index,
            "mesh": dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)),
            "stage": state.pipeline.stage}


def test_lagom_distributed_config_pp2(tmp_path):
    """``lagom(train_fn, DistributedConfig(sharding=ShardingSpec(pp=2)))``:
    two spawned gloo ranks, one a stage, end on JAX's pp=2 loss."""
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch import convert, experiment
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    jcfg = JConfig.tiny(dtype=jnp.float32, n_layers=N_LAYERS)
    batches = packed_batches(jcfg.vocab_size, STEPS + 1, seed=5)
    jtr = JTrainContext.create(JShardingSpec(pp=2), devices=jax.devices()[:2]).trainer(
        JDecoder(jcfg), optax.adamw(LR), n_microbatches=2)
    jstate = jtr.make_state(jax.random.key(0), batches[0])
    init = {k: v.numpy() for part in convert.decoder_stage_params_from_flax(jax.device_get(jstate.params), tcfg(), 2)
            for k, v in part.items()}
    for b in batches[1:]:
        jstate, jm = jtr.step(jstate, jtr.shard_batch(b))
    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    out = {}
    try:
        config = DistributedConfig(
            module=Decoder(tcfg(), device="meta"), dataset={"batches": batches, "init": init},
            hparams={"lr": LR}, sharding=ShardingSpec(pp=2), num_executors=2, mixed_precision=False,
            hb_interval=0.1, device="cpu",
        )
        t = threading.Thread(target=lambda: out.update(result=experiment.lagom(pp_train, config)), daemon=True)
        t.start()
        t.join(TIMEOUT_S)
        assert not t.is_alive(), f"lagom did not return within {TIMEOUT_S} s"
        ranks = [json.loads(p.read_text()) for p in sorted(Path(tmp_path / "torch").rglob(".outputs.json"))]
    finally:
        env_mod.set_instance(None)
    assert out["result"]["num_workers"] == 2
    assert out["result"]["loss"] == pytest.approx(float(jm["loss"]), rel=RTOL)
    assert sorted(r["stage"] for r in ranks) == [0, 1]
    for r in ranks:
        assert r["mesh"] == {"stage": 2, "data": 1, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
        assert r["loss"] == pytest.approx(float(jm["loss"]), rel=RTOL)
