"""The port's bucketed and ZeRO-1 steps on gloo ranks against the JAX
package's dense step under the same ``ShardingSpec``.

JAX's own bucket/zero parity test (``tests/test_overlap.py::
test_loss_parity_dense_bucketed_zero_20_steps``) fails in every run, so it
is no oracle: the port's three steps are held to JAX's dense Trainer on the
conftest's CPU devices. Three spawned worlds (``torch.multiprocessing``
spawn, a file rendezvous, every wait under ``TIMEOUT_S``), each rank
``TrainContext.create(ShardingSpec(dp=n), device="cpu")``, the tiny Decoder
in fp32 from the JAX weights (``decoder_params_from_flax``), AdamW with its
foreach kernels (as on a card), packed batches with a ``loss_mask``:

* dp=2: five steps each of dense (FSDP2's HSDP), ``bucket_mb=inf`` (the
  dense path itself), bucketed (``bucket_mb=0.25``: several buckets) and
  ZeRO-1 (``zero_stage=1, bucket_mb=0.25``); the ZeRO-1 run saves a
  checkpoint after step 2, which a dense trainer then restores and
  continues;
* dp=4: ZeRO-1 for five steps, saving after step 2; and the dp=2
  checkpoint restored into it (the flat layout re-padded for four shards);
* dp=2 again: the dp=4 checkpoint restored into ZeRO-1 at dp=2.

Limits: every mode's losses and grad norms within 2e-5 relative of JAX's
dense step (fp32; the sums run in another order) and its parameters after
the last step within 2e-5 absolute; ZeRO-1 against bucketed within 1e-6
(the same sums, the norm's in another order); ``bucket_mb=inf`` equal to
dense bit for bit; ZeRO-1's optimizer bytes a rank at most dense's / dp +
10 % (JAX's test); a restored run's next steps within 1e-5 of the run it
was saved from.
"""

import functools
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.parallel.overlap import opt_state_bytes_per_device
from maggy_tpu_torch.train import Checkpointer, TrainContext, adamw
from maggy_tpu_torch.train.checkpoint import restore_zero_compat

TIMEOUT_S = 120
LR = 5e-3
OPTIMIZER = functools.partial(adamw(LR), foreach=True)
STEPS = 5
SAVE_AFTER = 2
B, S = 4, 32
RTOL = 2e-5
PARAM_ATOL = 2e-5
ZERO_VS_BUCKET_RTOL = 1e-6
RESUME_RTOL = 1e-5
BUCKET_MB = 0.25
MODES = {"dense": {}, "inf": dict(bucket_mb=float("inf")), "bucket": dict(bucket_mb=BUCKET_MB),
         "zero": dict(zero_stage=1, bucket_mb=BUCKET_MB)}


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


def _run(ctx, params, batches, modes, steps, save=None, restore=None):
    """Each mode's trajectory on this rank: ``{mode: {losses, norms,
    final, opt_bytes, mode}}``. ``save`` = (mode, directory): that mode
    checkpoints after SAVE_AFTER steps. ``restore`` = (mode, directory):
    that mode starts from the directory's checkpoint instead and runs the
    remaining steps."""
    cfg = DecoderConfig.tiny(dtype=torch.float32)
    init = {k: torch.from_numpy(v) for k, v in params.items()}
    out = {}
    for mode in modes:
        trainer = ctx.trainer(Decoder(cfg, device="meta"), OPTIMIZER, **MODES[mode])
        state = trainer.make_state(0, batches[0], params=init)
        first = 0
        res = {}
        if restore is not None and restore[0] == mode:
            ckpt = Checkpointer(restore[1], async_save=False)
            state = restore_zero_compat(ckpt, state, live_meta=trainer.checkpoint_meta())
            ckpt.close()
            first = res["restored_step"] = state.step
        losses, norms = [], []
        for i in range(first, steps):
            if save is not None and save[0] == mode and i == SAVE_AFTER:
                ckpt = Checkpointer(save[1], async_save=False)
                ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
                ckpt.close()
            state, m = trainer.step(state, ctx.shard_batch(batches[1 + i]))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        final = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().numpy().copy()
                 for n, p in state.model.named_parameters()}
        res.update(losses=losses, norms=norms, final=final if ctx.process_index == 0 else None,
                   opt_bytes=opt_state_bytes_per_device(state), mode=trainer._overlap_mode()[0],
                   meta=trainer.checkpoint_meta())
        out[mode] = res
    return out


def _adopt(ctx, params, batches):
    """A dense one-device state one step in, adopted by a ZeRO-1 trainer:
    its next step against the dense trainer's."""
    from maggy_tpu_torch.train import Trainer

    cfg = DecoderConfig.tiny(dtype=torch.float32)
    dense = Trainer(Decoder(cfg, device="meta"), OPTIMIZER, device="cpu")
    dstate = dense.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in params.items()})
    dense.step(dstate, batches[1])
    zt = ctx.trainer(Decoder(cfg, device="meta"), OPTIMIZER, **MODES["zero"])
    adopted = zt.adopt_state(dstate, batches[0])
    adopted_step = adopted.step
    _, mz = zt.step(adopted, ctx.shard_batch(batches[2]))
    _, md = dense.step(dstate, batches[2])
    return dict(step=adopted_step, zero_loss=float(mz["loss"]), dense_loss=float(md["loss"]),
                zero_norm=float(mz["grad_norm"]), dense_norm=float(md["grad_norm"]))


def _rank(rank, n, init_file, out, params, batches, jobs):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
        ctx = TrainContext.create(ShardingSpec(dp=n), device="cpu")
        results = [_adopt(ctx, params, batches) if job == "adopt" else _run(ctx, params, batches, **job)
                   for job in jobs]
        out.put((rank, results))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _world(name, n, tmp, params, batches, jobs):
    """Every rank's results, in rank order; raises with a rank's traceback,
    or after TIMEOUT_S, and leaves no rank running. Each world rendezvouses
    in a file of its own (a file store is not reused)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, str(tmp / f"rendezvous_{name}"), out, params, batches, jobs))
             for r in range(n)]
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
def runs(tmp_path_factory):
    """JAX's dense trajectories at dp=2 and dp=4 and the port's three
    worlds, computed once for the module."""
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.convert import decoder_params_from_flax

    tmp = tmp_path_factory.mktemp("zero")
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    batches = packed_batches(jcfg.vocab_size, STEPS + 1)

    def torch_params(state):
        return {k: v.numpy() for k, v in decoder_params_from_flax(jax.device_get(unbox(state.params)), tcfg).items()}

    jax_runs, params = {}, None
    for n in (2, 4):
        jctx = JTrainContext.create(JShardingSpec(dp=n), devices=jax.devices()[:n])
        jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR))
        jstate = jtr.make_state(jax.random.key(0), batches[0])
        params = params or torch_params(jstate)
        jl, jg = [], []
        for batch in batches[1:]:
            jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
            jl.append(float(jm["loss"]))
            jg.append(float(jm["grad_norm"]))
        jax_runs[n] = dict(losses=jl, norms=jg, final=torch_params(jstate))
    ck2, ck4 = str(tmp / "zero_dp2"), str(tmp / "zero_dp4")
    dp2 = _world("dp2", 2, tmp, params, batches, [
        dict(modes=list(MODES), steps=STEPS, save=("zero", ck2)),
        dict(modes=["dense"], steps=STEPS, restore=("dense", ck2)),
        "adopt",
    ])
    dp4 = _world("dp4", 4, tmp, params, batches, [
        dict(modes=["zero"], steps=STEPS, save=("zero", ck4)),
        dict(modes=["zero"], steps=STEPS, restore=("zero", ck2)),
    ])
    back = _world("back", 2, tmp, params, batches, [dict(modes=["zero"], steps=STEPS, restore=("zero", ck4))])
    return dict(jax=jax_runs, dp2=dp2, dp4=dp4, back=back, ck2=ck2)


@pytest.mark.parametrize("n, mode", [(2, "dense"), (2, "inf"), (2, "bucket"), (2, "zero"), (4, "zero")])
def test_modes_match_jax_dense_step(runs, n, mode):
    ref = runs["jax"][n]
    ranks = runs["dp2" if n == 2 else "dp4"]
    assert ref["losses"][-1] < ref["losses"][0]  # it learns
    for rank in ranks:
        got = rank[0][mode]
        assert got["mode"] == {"dense": "off", "inf": "off"}.get(mode, mode)
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=RTOL)
    final = ranks[0][0][mode]["final"]
    assert sorted(final) == sorted(ref["final"])
    for name, want in ref["final"].items():
        np.testing.assert_allclose(final[name], want, rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_zero_matches_bucket_and_inf_is_dense(runs):
    for rank in runs["dp2"]:
        r = rank[0]
        np.testing.assert_allclose(r["zero"]["losses"], r["bucket"]["losses"], rtol=ZERO_VS_BUCKET_RTOL)
        np.testing.assert_allclose(r["zero"]["norms"], r["bucket"]["norms"], rtol=ZERO_VS_BUCKET_RTOL)
        # bucket_mb=inf resolves to the dense path itself: bit for bit
        assert r["inf"]["losses"] == r["dense"]["losses"] and r["inf"]["norms"] == r["dense"]["norms"]
        if r["inf"]["final"] is not None:
            for name, value in r["dense"]["final"].items():
                assert np.array_equal(r["inf"]["final"][name], value), name


@pytest.mark.parametrize("n", [2, 4])
def test_zero_shrinks_optimizer_bytes_per_rank(runs, n):
    dense = runs["dp2"][0][0]["dense"]["opt_bytes"]
    for rank in runs["dp2" if n == 2 else "dp4"]:
        zero = rank[0]["zero"]["opt_bytes"]
        assert zero < dense
        assert zero / dense <= 1 / n + 0.10
        assert rank[0]["zero"]["meta"]["zero"] == {"stage": 1, "bucket_mb": BUCKET_MB, "shards": n}
    assert runs["dp2"][0][0]["bucket"]["meta"]["zero"] == {"stage": 0, "bucket_mb": None, "shards": 1}


@pytest.mark.parametrize("case", ["zero_dp2_to_dense", "zero_dp2_to_zero_dp4", "zero_dp4_to_zero_dp2"])
def test_zero_checkpoint_restores_across_layouts(runs, case):
    """A ZeRO-1 checkpoint saved after step 2, restored into another
    layout (converted with a warning), continues the trajectory it was
    saved from."""
    world, job, mode, source = {
        "zero_dp2_to_dense": ("dp2", 1, "dense", ("dp2", "zero")),
        "zero_dp2_to_zero_dp4": ("dp4", 1, "zero", ("dp2", "zero")),
        "zero_dp4_to_zero_dp2": ("back", 0, "zero", ("dp4", "zero")),
    }[case]
    want = runs[source[0]][0][0][source[1]]
    for rank in runs[world]:
        got = rank[job][mode]
        assert got["restored_step"] == SAVE_AFTER
        np.testing.assert_allclose(got["losses"], want["losses"][SAVE_AFTER:], rtol=RESUME_RTOL)
        np.testing.assert_allclose(got["norms"], want["norms"][SAVE_AFTER:], rtol=RESUME_RTOL)


def test_zero_checkpoint_records_its_layout_and_holds_flat_buckets(runs):
    """The saved meta is JAX's, and the file holds one flat padded vector
    per bucket and moment (the full vectors, gathered from the shards)."""
    from maggy_tpu_torch.parallel import overlap

    ckpt = Checkpointer(runs["ck2"])
    assert ckpt.saved_meta()["zero"] == {"stage": 1, "bucket_mb": BUCKET_MB, "shards": 2}
    payload = ckpt._load(ckpt.latest_step())
    ckpt.close()
    params = payload["params"]
    plan = overlap.plan_buckets([params[n] for n in overlap.jax_leaf_order(list(params))], BUCKET_MB, pad_to=2)
    assert len(plan.buckets) > 1 and sorted(payload["optimizer"]["state"]) == list(range(len(plan.buckets)))
    for j, b in enumerate(plan.buckets):
        for key in ("exp_avg", "exp_avg_sq"):
            assert payload["optimizer"]["state"][j][key].shape == (b.padded_size,)


def test_zero_trainer_adopts_a_dense_state(runs):
    """``Trainer.adopt_state`` under ZeRO-1: a dense state one step in
    (parameters and AdamW moments, converted to the flat shards) takes the
    dense trainer's next step."""
    for rank in runs["dp2"]:
        r = rank[2]
        assert r["step"] == 1
        assert r["zero_loss"] == pytest.approx(r["dense_loss"], rel=RTOL)
        assert r["zero_norm"] == pytest.approx(r["dense_norm"], rel=RTOL)
