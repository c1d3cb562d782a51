"""The MoE decoder under the port's ``lagom``.

* ``HyperparameterOptConfig`` (random search, two trials, ``device="cpu"``):
  a train_fn that fits ``MoEConfig.tiny_moe`` on its leased device; every
  trial finishes, and the best trial's metric is what the same train_fn
  returns outside ``lagom``.
* ``DistributedConfig(sharding=ShardingSpec(ep=2), num_executors=2)``: two
  spawned gloo ranks (``OMP_NUM_THREADS=1``) train the fp32 MoE from the
  same weights over the ``expert`` axis. Each rank holds two of the four
  experts, and both report the final loss and aux loss of a one-device
  Trainer on the same batches within 2e-5 relative (the ranks route the
  same tokens; ``tests/test_torch_moe.py`` holds that Trainer to JAX's).
  ``DistributedConfig(sharding="ep")`` resolves to JAX's preset.

Every ``lagom`` call runs on a thread, waited for under ``TIMEOUT_S``.
"""

import numpy as np
import pytest
import torch

from maggy_tpu_torch import Searchspace
from maggy_tpu_torch.config import DistributedConfig, HyperparameterOptConfig
from maggy_tpu_torch.models import MoEConfig, MoEDecoder
from maggy_tpu_torch.optimizer import RandomSearch
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

TIMEOUT_S = 120.0
STEPS = 3
LR = 5e-3


@pytest.fixture()
def port_env(tmp_path):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


def _lagom(train_fn, config):
    from test_torch_pod import DriverThread

    run = DriverThread(train_fn, config)
    try:
        return run.join(TIMEOUT_S)
    finally:
        run.stop()


def _cfg(**kw):
    return MoEConfig.tiny_moe(dtype=torch.float32, group_size=32, **kw)


def hpo_train(hparams, reporter, devices):
    """Three fit steps of the tiny MoE on the trial's leased device."""
    trainer = Trainer(MoEDecoder(_cfg(), device="meta"), adamw(hparams["lr"]), device=devices[0])
    data = synthetic_lm_batches(256, 2, 32, seed=0)
    state = trainer.make_state(0, next(data))
    _, metrics = trainer.fit(state, data, STEPS, reporter=reporter, report_every=1, metrics_window=0, prefetch=0)
    return metrics["loss"]


def test_hpo_trains_the_moe_decoder(port_env):
    cfg = HyperparameterOptConfig(
        num_trials=2, optimizer=RandomSearch(seed=0), searchspace=Searchspace(lr=("DOUBLE", [1e-3, 3e-2])),
        direction="min", es_policy="none", hb_interval=0.05, device="cpu",
    )
    result = _lagom(hpo_train, cfg)
    assert result["errors"] == 0 and result["num_trials"] == 2

    class Quiet:
        def broadcast(self, value, step=None):
            pass

    best = result["best"]
    assert best["metric"] == hpo_train(best["params"], Quiet(), [torch.device("cpu")])


def ep_train(model, dataset, hparams, reporter, ctx):
    """The MoE on the context's mesh from the given weights, ``fit`` over
    the global batches; each rank reports its experts and metrics."""
    trainer = ctx.trainer(model, adamw(hparams["lr"]))
    batches = dataset["batches"]
    init = {k: torch.from_numpy(v) for k, v in dataset["init"].items()}
    state = trainer.make_state(0, batches[0], params=init)
    state, metrics = trainer.fit(state, iter(batches[1:]), num_steps=STEPS, reporter=reporter, report_every=1,
                                 metrics_window=0, prefetch=0)
    return {"metric": metrics["loss"], "loss": metrics["loss"], "aux_loss": metrics["aux_loss"],
            "rank": ctx.process_index, "ep": float(dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape))["expert"]),
            "experts": float(state.model.layers[0].moe.w_gate.shape[0])}


def test_lagom_expert_parallel(port_env, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = synthetic_lm_batches(256, 4, 32, seed=1)
    batches = [next(data) for _ in range(STEPS + 1)]
    dense = Trainer(MoEDecoder(_cfg(), device="meta"), adamw(LR), device="cpu")
    state = dense.make_state(0, batches[0])
    init = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    for batch in batches[1:]:
        state, m = dense.step(state, batch)
    config = DistributedConfig(
        module=MoEDecoder(_cfg(), device="meta"), dataset={"batches": batches, "init": init},
        hparams={"lr": LR}, sharding=ShardingSpec(ep=2), num_executors=2, mixed_precision=False,
        hb_interval=0.1, device="cpu",
    )
    result = _lagom(ep_train, config)
    assert result["num_workers"] == 2 and result["rank"] == 0.5
    assert result["ep"] == 2.0 and result["experts"] == 2.0
    assert result["loss"] == pytest.approx(float(m["loss"]), rel=2e-5)
    assert result["aux_loss"] == pytest.approx(float(m["aux_loss"]), rel=2e-5)
    assert DistributedConfig(sharding="ep", device="cpu").resolve_sharding(4) == ShardingSpec(ep=2, fsdp=2)
    assert np.isfinite(result["loss"])
