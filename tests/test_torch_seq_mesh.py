"""The ``seq`` axis inside the mesh: the port's Trainer with ring attention
over a mesh's ``seq`` axis, on gloo ranks, against the JAX Trainer with
``make_ring_attention(ctx.mesh)`` under the same ``ShardingSpec``.

One spawned world of four CPU ranks (``torch.multiprocessing`` spawn, a
file rendezvous, every wait under ``TIMEOUT_S``) runs, each from the JAX
``make_state`` weights (``decoder_params_from_flax``), AdamW with its
foreach kernels (as on a card):

* sp=2 x dp=2, sp=2 x fsdp=2 and sp=2 x tp=2: three steps on packed
  batches with a ``loss_mask`` (segments, positions restarting at each,
  unequal token weights across ranks and chunks). Every rank's loss and
  ``grad_norm`` within 2e-5 relative of JAX's at each step, every
  parameter after the last step within 2e-5 absolute (fp32: the sums over
  rows, chunks and ranks run in another order, as in
  ``tests/test_torch_dist_train.py``). The sp=2 x fsdp=2 run checkpoints
  after step 2; that checkpoint restores into a dense trainer on one
  device here, whose step 3 equals the mesh's.
* the port of ``tests/test_packed_sequences.py::
  test_decoder_trainer_packed_end_to_end`` at sp=2 x dp=2 (JAX's runs sp=4
  x dp=2 over 8 devices): two packed documents a row, five steps at lr
  1e-2, the losses equal to JAX's on the same spec and falling.
"""

import functools
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import ShardingSpec, make_ring_attention
from maggy_tpu_torch.train import Checkpointer, TrainContext, Trainer, adamw

TIMEOUT_S = 150
N = 4
LR = 5e-3
STEPS = 3
B, S = 4, 32
RTOL = 2e-5
PARAM_ATOL = 2e-5
SPECS = {"sp2_dp2": dict(sp=2, dp=2), "sp2_fsdp2": dict(sp=2, fsdp=2), "sp2_tp2": dict(sp=2, tp=2)}
CKPT_SPEC = "sp2_fsdp2"
# the port of test_packed_sequences.py's end-to-end case
E2E_SPEC, E2E_B, E2E_S, E2E_LR, E2E_STEPS = dict(sp=2, dp=2), 4, 64, 1e-2, 5


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


def e2e_batch(vocab: int):
    """Two packed documents a row, as the JAX test builds them."""
    rng = np.random.default_rng(0)
    seg = np.zeros((E2E_B, E2E_S), np.int32)
    seg[:, E2E_S // 2:] = 1
    pos = np.concatenate([np.arange(E2E_S // 2), np.arange(E2E_S - E2E_S // 2)])[None].repeat(E2E_B, 0)
    return {"tokens": rng.integers(0, vocab, (E2E_B, E2E_S)).astype(np.int32), "positions": pos.astype(np.int32),
            "segment_ids": seg}


def _full(p):
    return (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().numpy().copy()


def _trajectory(ctx, params, batches, lr, ckpt_dir=None):
    cfg = DecoderConfig.tiny(dtype=torch.float32, attention_fn=make_ring_attention(ctx.mesh))
    trainer = ctx.trainer(Decoder(cfg, device="meta"), functools.partial(adamw(lr), foreach=True))
    state = trainer.make_state(0, batches[0], params={k: torch.from_numpy(v) for k, v in params.items()})
    losses, norms = [], []
    for i, batch in enumerate(batches[1:]):
        if ckpt_dir is not None and i == len(batches) - 2:
            ckpt = Checkpointer(ckpt_dir, async_save=False)
            ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
            ckpt.close()
        state, m = trainer.step(state, ctx.shard_batch(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = {name: _full(p) for name, p in state.model.named_parameters()}
    return dict(losses=losses, norms=norms, final=final if ctx.process_index == 0 else None,
                meta=trainer.checkpoint_meta(), seq_rank=ctx.mesh.get_local_rank("seq"))


def _rank(rank, init_file, out, params, batches, e2e_params, ckpt_dir):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=N)
        results = {}
        for key, kw in SPECS.items():
            ctx = TrainContext.create(ShardingSpec(**kw), device="cpu")
            results[key] = _trajectory(ctx, params, batches, LR, ckpt_dir if key == CKPT_SPEC else None)
        ctx = TrainContext.create(ShardingSpec(**E2E_SPEC), device="cpu")
        batch = e2e_batch(DecoderConfig.tiny().vocab_size)
        results["e2e"] = _trajectory(ctx, e2e_params, [batch] * (E2E_STEPS + 1), E2E_LR)
        out.put((rank, results))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _run_ranks(tmp, *args):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "rendezvous"), out, *args)) for r in range(N)]
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
    failed = [f"rank {r[0]} failed:\n{r[2]}" for r in results if isinstance(r[1], str) and r[1] == "error"]
    if failed:
        raise AssertionError("\n".join(failed))
    return [r[1] for r in results]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX trajectories under each spec and the port's world, once for
    the module."""
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.ringattention import make_ring_attention as jmake_ring_attention
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.convert import decoder_params_from_flax

    tmp = tmp_path_factory.mktemp("seq_mesh")
    tcfg = DecoderConfig.tiny(dtype=torch.float32)

    def jax_run(spec_kw, batches, lr):
        spec = JShardingSpec(**spec_kw)
        jctx = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices])
        jcfg = JConfig.tiny(dtype=jnp.float32, attention_fn=jmake_ring_attention(jctx.mesh))
        jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(lr))
        jstate = jtr.make_state(jax.random.key(0), batches[0])

        def torch_params(state):
            tree = jax.device_get(unbox(state.params))
            return {k: v.numpy() for k, v in decoder_params_from_flax(tree, tcfg).items()}

        init = torch_params(jstate)
        losses, norms = [], []
        for batch in batches[1:]:
            jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
            losses.append(float(jm["loss"]))
            norms.append(float(jm["grad_norm"]))
        return dict(losses=losses, norms=norms, init=init, final=torch_params(jstate))

    batches = packed_batches(tcfg.vocab_size, STEPS + 1)
    jax_runs = {key: jax_run(kw, batches, LR) for key, kw in SPECS.items()}
    e2e = jax_run(E2E_SPEC, [e2e_batch(tcfg.vocab_size)] * (E2E_STEPS + 1), E2E_LR)
    params = jax_runs[CKPT_SPEC]["init"]
    ckpt_dir = str(tmp / "ckpt")
    ranks = _run_ranks(tmp, params, batches, e2e["init"], ckpt_dir)
    return dict(jax=jax_runs, e2e=e2e, ranks=ranks, batches=batches, init=params, ckpt_dir=ckpt_dir)


@pytest.mark.parametrize("key", list(SPECS))
def test_ring_in_mesh_matches_jax_trainer(run, key):
    ref = run["jax"][key]
    assert ref["losses"][-1] < ref["losses"][0]  # it learns
    for rank in run["ranks"]:
        got = rank[key]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=RTOL)
        names = {"dp": "data", "fsdp": "fsdp", "tp": "tensor", "sp": "seq"}
        assert got["meta"]["mesh_axes"] == {names[k]: v for k, v in SPECS[key].items()}
    assert sorted(r[key]["seq_rank"] for r in run["ranks"]) == [0, 0, 1, 1]
    final = run["ranks"][0][key]["final"]
    assert sorted(final) == sorted(ref["final"])
    for name, want in ref["final"].items():
        np.testing.assert_allclose(final[name], want, rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert not np.array_equal(final[name], run["init"][name]) or name.endswith("scale")


def test_packed_end_to_end_matches_jax(run):
    ref = run["e2e"]
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["e2e"]["losses"], ref["losses"], rtol=RTOL)
        np.testing.assert_allclose(rank["e2e"]["norms"], ref["norms"], rtol=RTOL)
        assert rank["e2e"]["losses"][-1] < rank["e2e"]["losses"][0]


def test_seq_mesh_checkpoint_restores_on_one_device(run):
    """The checkpoint written under sp=2 x fsdp=2 is the one-device format:
    a dense trainer restores it and takes the mesh's step 3."""
    cfg = DecoderConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(LR), device="cpu")
    state = trainer.make_state(0, run["batches"][0],
                               params={k: torch.from_numpy(v) for k, v in run["init"].items()})
    ckpt = Checkpointer(run["ckpt_dir"])
    assert ckpt.saved_meta()["mesh_axes"] == {"fsdp": 2, "seq": 2}
    with pytest.warns(UserWarning, match="mesh_axes"):
        state = ckpt.restore(state, expect_meta=trainer.checkpoint_meta())
    ckpt.close()
    assert state.step == STEPS - 1
    _, m = trainer.step(state, run["batches"][STEPS])
    assert float(m["loss"]) == pytest.approx(run["ranks"][0][CKPT_SPEC]["losses"][-1], rel=RTOL)
    assert float(m["grad_norm"]) == pytest.approx(run["jax"][CKPT_SPEC]["norms"][-1], rel=RTOL)
