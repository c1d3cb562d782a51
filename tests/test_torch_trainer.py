"""The port's losses, data stream and Trainer against the JAX package's.

The trajectory test starts both trainers from the same weights (the JAX
``make_state`` init, converted) and feeds both the same synthetic batch
stream; the JAX side trains with ``optax.adamw(lr)`` on a one-device mesh,
the port with ``adamw(lr)``. Everything is fp32.

Tolerances: losses 1e-5 absolute (the same fp32 math; sums run in another
order), the per-step loss and grad-norm trajectory 2e-5 relative (measured
1.3e-6 over 12 steps) — Adam divides by the root of the second moment, so
last-bit differences in the gradients grow a little with every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models import Decoder as JDecoder
from maggy_tpu.models import DecoderConfig as JConfig
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu.train import TrainContext
from maggy_tpu.train import data as jdata
from maggy_tpu.train import trainer as jtrainer
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.train import (
    BatchIterator,
    Trainer,
    adamw,
    classification_loss_fn,
    lm_loss_fn,
    synthetic_lm_batches,
)

torch.set_num_threads(2)
LR = 5e-3
STEPS = 12


def _logits_batch(seed=0, b=3, s=10, v=17):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, v)).astype(np.float32) * 3
    batch = {
        "tokens": rng.integers(0, v, (b, s)).astype(np.int32),
        "loss_mask": (rng.random((b, s)) > 0.3).astype(np.float32),
        "segment_ids": np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32),
    }
    return logits, batch


@pytest.mark.parametrize("keys", [(), ("loss_mask",), ("segment_ids",), ("loss_mask", "segment_ids")])
def test_lm_loss_matches(keys):
    logits, full = _logits_batch()
    batch = {"tokens": full["tokens"], **{k: full[k] for k in keys}}
    ref = float(jtrainer.lm_loss_fn(jnp.asarray(logits), {k: jnp.asarray(v) for k, v in batch.items()}))
    out = float(lm_loss_fn(torch.from_numpy(logits), {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert out == pytest.approx(ref, abs=1e-5)


def test_classification_loss_matches():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    ref = float(jtrainer.classification_loss_fn(jnp.asarray(logits), {"labels": jnp.asarray(labels)}))
    out = float(classification_loss_fn(torch.from_numpy(logits), {"labels": torch.from_numpy(labels)}))
    assert out == pytest.approx(ref, abs=1e-5)


def test_data_streams_match():
    a = synthetic_lm_batches(256, 4, 16, seed=3)
    b = jdata.synthetic_lm_batches(256, 4, 16, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    arrays = {"x": np.arange(50).reshape(25, 2)}
    mine, ref = BatchIterator(arrays, 4, seed=1), jdata.BatchIterator(arrays, 4, seed=1)
    assert mine.skip(9) == ref.skip(9)
    for _ in range(4):
        np.testing.assert_array_equal(next(mine)["x"], next(ref)["x"])


def test_adamw_uses_optax_defaults():
    opt = adamw(1e-3)([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 1e-4)


def test_trajectory_matches_jax_trainer():
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    jstream = jdata.synthetic_lm_batches(jcfg.vocab_size, 8, 32, seed=0)
    tstream = synthetic_lm_batches(tcfg.vocab_size, 8, 32, seed=0)
    sample = next(jstream)
    next(tstream)

    ctx = TrainContext.create("dp", devices=jax.devices()[:1])
    jtr = ctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), sample)
    params = decoder_params_from_flax(jax.device_get(unbox(jstate.params)), tcfg)

    ttr = Trainer(Decoder(tcfg, device="meta"), adamw(LR), device="cpu")
    tstate = ttr.make_state(0, sample, params=params)

    jl, jg, tl, tg = [], [], [], []
    for _ in range(STEPS):
        jstate, jm = jtr.step(jstate, jtr.shard_batch(next(jstream)))
        tstate, tm = ttr.step(tstate, next(tstream))
        jl.append(float(jm["loss"]))
        jg.append(float(jm["grad_norm"]))
        tl.append(float(tm["loss"]))
        tg.append(float(tm["grad_norm"]))
        assert int(tm["step"]) == int(jm["step"])
    assert set(tm) == set(jm)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    np.testing.assert_allclose(tg, jg, rtol=2e-5)
    assert tl[-1] < tl[0]  # it learns


@pytest.mark.parametrize("window,every", [(2, 2), (2, 1), (0, 1)])
def test_fit_broadcasts_like_jax_fit(window, every):
    """The lagged-metrics drain broadcasts at the same step boundaries, with
    the same stamps, as the JAX trainer's fit."""
    steps = 5

    class Reporter:
        def __init__(self):
            self.seen = []

        def broadcast(self, value, step):
            self.seen.append((step, value))

    jcfg = JConfig.tiny(dtype=jnp.float32)
    ctx = TrainContext.create("dp", devices=jax.devices()[:1])
    jtr = ctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jdata_iter = jdata.synthetic_lm_batches(jcfg.vocab_size, 4, 16, seed=0)
    jstate = jtr.make_state(jax.random.key(0), next(jdata_iter))
    jrep = Reporter()
    jtr.fit(jstate, jdata_iter, steps, reporter=jrep, report_every=every,
            metric_sign=-1.0, metrics_window=window, prefetch=0)

    cfg = DecoderConfig.tiny(dtype=torch.float32)
    tr = Trainer(Decoder(cfg, device="meta"), adamw(LR), device="cpu")
    data = synthetic_lm_batches(cfg.vocab_size, 4, 16, seed=0)
    state = tr.make_state(torch.Generator().manual_seed(0), next(data))
    rep = Reporter()
    state, out = tr.fit(state, data, steps, reporter=rep, report_every=every,
                        metric_sign=-1.0, metrics_window=window)
    assert state.step == steps
    assert {"loss", "aux_loss", "total_loss", "grad_norm", "step", "steps_per_sec"} <= set(out)
    assert [s for s, _ in rep.seen] == [s for s, _ in jrep.seen]
    assert all(v < 0 for _, v in rep.seen)


def test_eval_logits_and_evaluate():
    cfg = DecoderConfig.tiny(dtype=torch.float32)
    tr = Trainer(Decoder(cfg, device="meta"), adamw(LR), device="cpu")
    data = synthetic_lm_batches(cfg.vocab_size, 4, 16, seed=0)
    state = tr.make_state(0, next(data))
    logits = tr.eval_logits(state, next(data))
    assert logits.shape == (4, 16, cfg.vocab_size) and logits.dtype == torch.float32
    ev = tr.evaluate(state, data, 2)
    assert np.isfinite(ev["loss"]) and state.step == 0
