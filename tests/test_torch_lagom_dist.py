"""``lagom(train_fn, DistributedConfig(...))`` in the port: one spawned gloo
process per rank on the CPU, against the JAX Trainer.

* ``DistributedConfig(sharding="fsdp", num_executors=2, device="cpu")`` on
  the tiny Decoder (fp32, ``mixed_precision=False``) from the JAX
  ``make_state`` weights: the train_fn (the JAX package's
  ``tests/test_distributed.py`` e2e shape) fits three steps on packed,
  masked batches. The result has the shape of JAX's ``_aggregate``:
  ``num_workers`` 2 and the ranks' mean ``metric`` and outputs. Both ranks
  report the same final loss, and it equals the JAX ``Trainer``'s under
  ``ShardingSpec(fsdp=2)`` from the same weights and batches within 2e-5
  relative (fp32; the dense trajectory's tolerance in
  ``tests/test_torch_trainer.py``). Each rank saw its rendezvous in
  ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``.
* A lambda or a closure ``train_fn`` raises ``TypeError`` before any
  process starts.
* A rank that raises fails the run, and the other rank, which would wait
  forever, is terminated; ranks that outlive ``worker_timeout`` are
  killed and fail the run: no child process is left either way.
* A train_fn that checkpoints into each rank's own ``trial_dir`` (rank 0's
  ``worker_0``, rank 1's ``worker_1``) under fsdp=2, with a preemption
  notice on rank 1 only: both ranks save at the same step and return
  ``preempted``; only rank 0's directory holds the checkpoint; a
  ``fit(resume="auto")`` from there resumes both ranks at that step and
  ends on the uninterrupted run's loss.
* ``zero_lvl=1`` (dp=2 with ZeRO-1) and ``sharding="dp", bucket_mb=0.25``
  (the bucketed step) run through ``lagom``: each rank's trainer resolves
  that mode from the spec the config stamps, and the final loss equals the
  JAX Trainer's dense step under ``ShardingSpec(dp=2)`` within 2e-5.
* ``elastic=True`` with ``min_slices`` above the launch width raises the
  JAX driver's error before any rank starts; the JAX package's
  ``DistributedConfig`` is no port config and raises ``TypeError`` naming
  the port's.

Every ``lagom`` call runs on a thread, waited for under ``TIMEOUT_S``.
"""

import json
import multiprocessing
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from maggy_tpu_torch.config import DistributedConfig
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.train import adamw

TIMEOUT_S = 120.0
LR = 5e-3
STEPS = 3
B, S = 4, 32


@pytest.fixture()
def port_env(tmp_path):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


def _lagom(train_fn, config):
    """``lagom`` on a thread, waited for under ``TIMEOUT_S``; a run that
    outlives the wait is aborted, its ranks reaped, before the test fails."""
    from test_torch_pod import DriverThread

    run = DriverThread(train_fn, config)
    try:
        return run.join(TIMEOUT_S)
    finally:
        run.stop()


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


def fsdp_train(model, dataset, hparams, reporter, ctx):
    """The oblivious train_fn: a trainer from the context, the shared
    weights, ``fit`` over the global batches (each rank takes its rows)."""
    trainer = ctx.trainer(model, adamw(hparams["lr"]))
    batches = dataset["batches"]
    init = {k: torch.from_numpy(v) for k, v in dataset["init"].items()}
    state = trainer.make_state(0, batches[0], params=init)
    state, metrics = trainer.fit(state, iter(batches[1:]), num_steps=STEPS, reporter=reporter, report_every=1,
                                 metric_sign=-1.0)
    env = {k: os.environ[k] for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    return {"metric": -metrics["loss"], "loss": metrics["loss"], "rank": ctx.process_index,
            "world": ctx.num_processes, "mesh": dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)),
            "env": env, "dtype": str(state.model.cfg.dtype), "mode": trainer._overlap_mode()[0],
            "zero": trainer.checkpoint_meta()["zero"]}


PREEMPT_STEPS, NOTICE_AFTER = 6, 3


class _NoticeOnRank1:
    """A reporter that raises the preemption flag on rank 1 alone, after
    step ``NOTICE_AFTER``."""

    def __init__(self, rank):
        self.rank = rank

    def broadcast(self, value, step):
        from maggy_tpu_torch.resilience import preemption

        if self.rank == 1 and step == NOTICE_AFTER:
            preemption.request()


def preempted_train(model, dataset, hparams, ctx, trial_dir):
    """Under fsdp=2: an uninterrupted fit; a fit checkpointing every 2
    steps into this rank's ``trial_dir`` that rank 1 alone is told to stop;
    a ``fit(resume="auto")`` from the same directories, saving nothing."""
    from maggy_tpu_torch.resilience import preemption
    from maggy_tpu_torch.train import Checkpointer

    batches = dataset["batches"]

    def fresh():
        trainer = ctx.trainer(Decoder(model.cfg, device="meta"), adamw(hparams["lr"]))
        return trainer, trainer.make_state(0, batches[0])

    trainer, state = fresh()
    _, whole = trainer.fit(state, iter(batches[1:]), num_steps=PREEMPT_STEPS)
    trainer, state = fresh()
    ckpt = Checkpointer(os.path.join(trial_dir, "ckpt"))
    state, cut = trainer.fit(state, iter(batches[1:]), num_steps=PREEMPT_STEPS, checkpointer=ckpt,
                             checkpoint_every=2, reporter=_NoticeOnRank1(ctx.process_index), report_every=1,
                             metrics_window=0)
    ckpt.close()
    saved_at = state.step
    preemption.HOOK.clear()
    trainer, state = fresh()
    ckpt = Checkpointer(os.path.join(trial_dir, "ckpt"))
    state, resumed = trainer.fit(state, iter(batches[1:]), num_steps=PREEMPT_STEPS, checkpointer=ckpt,
                                 resume="auto")
    ckpt.close()
    return {"metric": resumed["loss"], "rank": ctx.process_index, "whole_loss": whole["loss"],
            "preempted": cut.get("preempted", 0.0), "saved_at": saved_at, "resumed_from": resumed.get("resumed_from"), "resumed_loss": resumed["loss"],
            "final_step": state.step, "own_steps": Checkpointer(os.path.join(trial_dir, "ckpt")).all_steps()}


def failing_train(ctx):
    """Rank 1 raises; rank 0 would wait for it forever."""
    if ctx.process_index == 1:
        raise ValueError("rank 1 gives up")
    time.sleep(600)
    return 0.0


def sleeping_train(ctx):
    """Every rank outlives the config's worker_timeout."""
    time.sleep(600)
    return 0.0


def _rank_children():
    return [p for p in multiprocessing.active_children() if p.name.startswith("maggy-rank-")]


def _jax_reference(**spec_kw):
    """The JAX Trainer's weights (as the port's state dict), batches and
    final loss under ``ShardingSpec(**spec_kw)``."""
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
    jctx = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices])
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    batches = packed_batches(jcfg.vocab_size, STEPS + 1)
    jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), batches[0])
    init = {k: v.numpy() for k, v in decoder_params_from_flax(jax.device_get(unbox(jstate.params)), tcfg).items()}
    for batch in batches[1:]:
        jstate, jm = jtr.step(jstate, jtr.shard_batch(batch))
    return init, batches, float(jm["loss"])


def test_lagom_fsdp_matches_jax_trainer(port_env):
    init, batches, jloss = _jax_reference(fsdp=2)

    config = DistributedConfig(
        module=Decoder(DecoderConfig.tiny(), device="meta"), dataset={"batches": batches, "init": init},
        hparams={"lr": LR}, sharding="fsdp", num_executors=2, mixed_precision=False, hb_interval=0.1,
        device="cpu",
    )
    result = _lagom(fsdp_train, config)
    assert result["num_workers"] == 2 and result["world"] == 2
    assert result["rank"] == 0.5  # the ranks' outputs are averaged
    assert result["loss"] == pytest.approx(jloss, rel=2e-5)
    assert result["metric"] == pytest.approx(-jloss, rel=2e-5)
    outs = sorted(Path(port_env.root).rglob(".outputs.json"))  # each rank's persisted outputs
    ranks = [json.loads(p.read_text()) for p in outs]
    assert [r["rank"] for r in ranks] == [0, 1] and [p.parent.name for p in outs] == ["worker_0", "worker_1"]
    assert ranks[0]["loss"] == ranks[1]["loss"] == pytest.approx(jloss, rel=2e-5)
    for r in ranks:
        assert r["mesh"] == {"stage": 1, "data": 1, "fsdp": 2, "expert": 1, "seq": 1, "tensor": 1}
        assert r["env"]["RANK"] == str(r["rank"]) and r["env"]["WORLD_SIZE"] == "2"
        assert r["env"]["MASTER_PORT"] == ranks[0]["env"]["MASTER_PORT"]
        assert r["dtype"] == "torch.float32"  # mixed_precision=False
    assert _rank_children() == []


def test_unpicklable_train_fn_raises_before_any_spawn(port_env):
    config = DistributedConfig(module=Decoder(DecoderConfig.tiny(), device="meta"), num_executors=2,
                               device="cpu", hb_interval=0.1)
    scale = 2.0

    def closure(ctx):
        return scale

    for fn in (lambda ctx: 1.0, closure):
        with pytest.raises(TypeError, match="cannot be pickled"):
            _lagom(fn, config)
        assert _rank_children() == []


def test_a_failing_rank_fails_the_run_and_leaves_no_child(port_env):
    config = DistributedConfig(num_executors=2, device="cpu", hb_interval=0.1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up|exited with code"):
        _lagom(failing_train, config)
    assert time.monotonic() - t0 < 60  # the waiting rank was terminated, not waited out
    assert _rank_children() == []


def test_a_rank_past_worker_timeout_is_killed(port_env):
    config = DistributedConfig(num_executors=2, device="cpu", hb_interval=0.1, worker_timeout=5.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="worker_timeout"):
        _lagom(sleeping_train, config)
    assert time.monotonic() - t0 < 60
    assert _rank_children() == []


@pytest.mark.parametrize("kw, mode, zero", [
    (dict(zero_lvl=1), "zero", {"stage": 1, "bucket_mb": None, "shards": 2}),
    (dict(sharding="dp", bucket_mb=0.25), "bucket", {"stage": 0, "bucket_mb": None, "shards": 1}),
], ids=["zero_lvl_1", "bucket_mb"])
def test_zero_options_run_through_lagom(port_env, kw, mode, zero):
    init, batches, jloss = _jax_reference(dp=2)
    config = DistributedConfig(
        module=Decoder(DecoderConfig.tiny(), device="meta"), dataset={"batches": batches, "init": init},
        hparams={"lr": LR}, num_executors=2, mixed_precision=False, hb_interval=0.1, device="cpu", **kw,
    )
    result = _lagom(fsdp_train, config)
    assert result["num_workers"] == 2 and result["loss"] == pytest.approx(jloss, rel=2e-5)
    ranks = [json.loads(p.read_text()) for p in sorted(Path(port_env.root).rglob(".outputs.json"))]
    for r in ranks:
        assert r["mesh"] == {"stage": 1, "data": 2, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
        assert (r["mode"], r["zero"]) == (mode, zero)
        assert r["loss"] == pytest.approx(jloss, rel=2e-5)
    assert _rank_children() == []


@pytest.mark.parametrize("kw, error, match", [
    # elastic membership is ported (tests/test_torch_elastic.py): a floor
    # above the launch width raises the JAX driver's own error
    (dict(elastic=True, min_slices=3), ValueError, r"min_slices=3 exceeds the launch width \(2 slice\(s\)\)"),
], ids=["elastic"])
def test_unported_options_raise_naming_their_items(port_env, kw, error, match):
    with pytest.raises(error, match=match):
        _lagom(fsdp_train, DistributedConfig(device="cpu", num_executors=2, **kw))
    assert _rank_children() == []


def test_preemption_on_one_rank_saves_and_resumes_every_rank(port_env):
    """The checkpoint under a mesh is rank 0's, whatever directory each
    rank names, and a notice on any rank stops every rank at one step."""
    config = DistributedConfig(
        module=Decoder(DecoderConfig.tiny(), device="meta"),
        dataset={"batches": packed_batches(DecoderConfig.tiny().vocab_size, PREEMPT_STEPS + 1)},
        hparams={"lr": LR}, sharding="fsdp", num_executors=2, mixed_precision=False, hb_interval=0.1,
        device="cpu",
    )
    _lagom(preempted_train, config)
    ranks = sorted((json.loads(p.read_text()) for p in Path(port_env.root).rglob(".outputs.json")),
                   key=lambda r: r["rank"])
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["preempted"] == 1.0 and r["saved_at"] == NOTICE_AFTER
        assert r["resumed_from"] == NOTICE_AFTER and r["final_step"] == PREEMPT_STEPS
        assert r["resumed_loss"] == pytest.approx(r["whole_loss"], rel=1e-6)
    # the periodic save at 2 and the preemption save at 3, in rank 0's
    # trial_dir; rank 1's stays empty, and resumed from rank 0's all the same
    assert ranks[0]["own_steps"] == [2, NOTICE_AFTER]
    assert ranks[1]["own_steps"] == []
    assert _rank_children() == []


def test_jax_distributed_config_is_no_port_config(port_env):
    from maggy_tpu.config import DistributedConfig as JDistributedConfig

    with pytest.raises(TypeError, match=r"Unsupported config type DistributedConfig.*\bDistributedConfig\)"):
        _lagom(fsdp_train, JDistributedConfig.__new__(JDistributedConfig))
