"""The port's Trainer on a mesh of gloo ranks against the JAX Trainer under
the same ``ShardingSpec``.

Each spec runs as one CPU process per rank (``torch.multiprocessing``
spawn, a file rendezvous in a temporary directory, every wait under
``TIMEOUT_S``): ``TrainContext.create(spec, device="cpu")``, the tiny
Decoder in fp32 from the JAX ``make_state`` weights (converted by
``decoder_params_from_flax``), three AdamW steps (its foreach kernels, as
on a card) on packed batches with a ``loss_mask``, so the ranks' token
weights differ. The JAX side is its
``Trainer`` under the same spec on the conftest's CPU devices.

* dp=2, fsdp=2, tp=2 and fsdp=2 x tp=2 (4 ranks): every rank's loss and
  ``grad_norm`` at each step within 2e-5 relative of JAX's, and every
  parameter after the last step within 2e-5 absolute (fp32; the sums over
  rows and ranks run in another order, and Adam divides by the root of the
  second moment, so last-bit differences grow a little with each step;
  ``tests/test_torch_trainer.py`` holds the dense trajectory to the same
  2e-5).
* Each run saves a checkpoint after step 2 and restores it on its own mesh
  into a fresh state: step 3 again gives the same loss. The checkpoint
  saved under fsdp=2 restores into a dense one-rank trainer, whose step 3
  equals the uninterrupted run's. A dense state one step in, adopted onto
  each mesh (``Trainer.adopt_state``), takes the dense trainer's next step.
"""

import functools
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.train import Checkpointer, TrainContext, Trainer, adamw

TIMEOUT_S = 120
LR = 5e-3
# the optimizer as it runs on a card, where AdamW defaults to its foreach
# kernels (the CPU defaults to the per-tensor loop)
OPTIMIZER = functools.partial(adamw(LR), foreach=True)
STEPS = 3
B, S = 4, 32
RTOL = 2e-5
PARAM_ATOL = 2e-5
SPECS = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "tp2": dict(tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}


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


def _full(p):
    return (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().numpy().copy()


def _rank(rank, n, init_file, out, spec_kw, params, batches, ckpt_dir):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
        ctx = TrainContext.create(ShardingSpec(**spec_kw), device="cpu")
        cfg = DecoderConfig.tiny(dtype=torch.float32)
        init = {k: torch.from_numpy(v) for k, v in params.items()}

        def fresh():
            trainer = ctx.trainer(Decoder(cfg, device="meta"), OPTIMIZER)
            return trainer, trainer.make_state(0, batches[0], params=init)

        trainer, state = fresh()
        ckpt = Checkpointer(ckpt_dir, async_save=False)
        losses, norms = [], []
        for i, batch in enumerate(batches[1:]):
            if i == STEPS - 1:
                ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
            state, m = trainer.step(state, ctx.shard_batch(batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        final = {name: _full(p) for name, p in state.model.named_parameters()}
        # the checkpoint restored on this mesh into a fresh state: step 3 again
        trainer2, state2 = fresh()
        state2 = ckpt.restore(state2, expect_meta=trainer2.checkpoint_meta())
        restored_step = state2.step
        _, m2 = trainer2.step(state2, ctx.shard_batch(batches[STEPS]))
        ckpt.close()
        # a dense state after one step, adopted onto the mesh: its next step
        # equals the dense trainer's
        dense = Trainer(Decoder(cfg, device="meta"), adamw(LR), device="cpu")
        dstate = dense.make_state(0, batches[0], params=init)
        dense.step(dstate, batches[1])
        trainer3 = ctx.trainer(Decoder(cfg, device="meta"), OPTIMIZER)
        adopted = trainer3.adopt_state(dstate, batches[0])
        adopted_step = adopted.step
        _, m3 = trainer3.step(adopted, ctx.shard_batch(batches[2]))
        _, md = dense.step(dstate, batches[2])
        out.put((rank, dict(losses=losses, norms=norms, final=final if rank == 0 else None,
                            restored_step=restored_step, restored_loss=float(m2["loss"]),
                            adopted_step=adopted_step, adopted_loss=float(m3["loss"]),
                            dense_loss=float(md["loss"]), meta=trainer.checkpoint_meta())))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _run_ranks(n, tmp_path, *args):
    """Every rank's result, in rank order; raises with a rank's traceback,
    or after TIMEOUT_S, and leaves no rank running."""
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
    ``SPECS[key]``, computed once for the module."""
    runs = {}

    def get(key):
        if key not in runs:
            runs[key] = _both(SPECS[key], tmp_path_factory.mktemp(key))
        return runs[key]

    return get


def _both(spec_kw, tmp):
    # the JAX package is imported here, not at the top: the spawned ranks
    # import this module and need only the port
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.convert import decoder_params_from_flax

    spec = JShardingSpec(**spec_kw)
    n = spec.num_devices
    jctx = JTrainContext.create(spec, devices=jax.devices()[:n])
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    batches = packed_batches(jcfg.vocab_size, STEPS + 1)
    jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), batches[0])

    def torch_params(state):
        return {k: v.numpy() for k, v in decoder_params_from_flax(jax.device_get(unbox(state.params)), tcfg).items()}

    params = torch_params(jstate)
    jl, jg = [], []
    for batch in batches[1:]:
        jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
        jl.append(float(jm["loss"]))
        jg.append(float(jm["grad_norm"]))
    ckpt_dir = str(tmp / "ckpt")
    ranks = _run_ranks(n, tmp, spec_kw, params, batches, ckpt_dir)
    return dict(jl=jl, jg=jg, jparams=torch_params(jstate), init=params, batches=batches, ranks=ranks,
                ckpt_dir=ckpt_dir)


@pytest.mark.parametrize("key", list(SPECS))
def test_mesh_trainer_matches_jax_trainer(run, key):
    r = run(key)
    assert r["jl"][-1] < r["jl"][0]  # it learns
    for rank in r["ranks"]:  # every rank reports the global loss and norm
        np.testing.assert_allclose(rank["losses"], r["jl"], rtol=RTOL)
        np.testing.assert_allclose(rank["norms"], r["jg"], rtol=RTOL)
        assert rank["meta"]["mesh_axes"] == {
            {"dp": "data", "fsdp": "fsdp", "tp": "tensor"}[k]: v for k, v in SPECS[key].items()}
        assert rank["meta"]["num_devices"] == len(r["ranks"])
    final = r["ranks"][0]["final"]
    assert sorted(final) == sorted(r["jparams"])
    for name, want in r["jparams"].items():
        np.testing.assert_allclose(final[name], want, rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert not np.array_equal(final[name], r["init"][name]) or name.endswith("scale")


@pytest.mark.parametrize("key", list(SPECS))
def test_checkpoint_restores_on_its_mesh(run, key):
    """Saved after step 2 on the mesh, restored into a fresh state there:
    the same step, and step 3 gives the uninterrupted loss."""
    for rank in run(key)["ranks"]:
        assert rank["restored_step"] == STEPS - 1
        assert rank["restored_loss"] == pytest.approx(rank["losses"][-1], rel=1e-6)


@pytest.mark.parametrize("key", list(SPECS))
def test_adopt_state_places_a_dense_state_on_the_mesh(run, key):
    """``Trainer.adopt_state``: a dense state one step in (parameters and
    AdamW moments), laid out on the mesh, takes the dense trainer's next
    step."""
    for rank in run(key)["ranks"]:
        assert rank["adopted_step"] == 1
        assert rank["adopted_loss"] == pytest.approx(rank["dense_loss"], rel=RTOL)


def test_fsdp_checkpoint_restores_into_a_dense_trainer(run):
    """The checkpoint written under fsdp=2 is the one-device format: a dense
    trainer restores it and continues the same trajectory."""
    r = run("fsdp2")
    cfg = DecoderConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(LR), device="cpu")
    state = trainer.make_state(0, r["batches"][0], params={k: torch.from_numpy(v) for k, v in r["init"].items()})
    ckpt = Checkpointer(r["ckpt_dir"])
    assert ckpt.saved_meta()["mesh_axes"] == {"fsdp": 2}
    with pytest.warns(UserWarning, match="mesh_axes"):
        state = ckpt.restore(state, expect_meta=trainer.checkpoint_meta())
    assert state.step == STEPS - 1
    _, m = trainer.step(state, r["batches"][STEPS])
    assert float(m["loss"]) == pytest.approx(r["ranks"][0]["losses"][-1], rel=RTOL)
    assert float(m["grad_norm"]) == pytest.approx(r["jg"][-1], rel=RTOL)
