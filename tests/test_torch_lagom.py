"""The port's ``lagom()`` control plane on the CPU (``device="cpu"``).

A seeded randomsearch gives the same trial ids and final metrics under both
packages' ``lagom``; an ASHA study trains the port's ``Decoder`` with its
``Trainer``; BASELINE config 1 runs the port's MLP from converted flax
params as a single run; and the driver's early stopping, failure handling,
``resume_from``, leases, ``ctx`` and no-fallback rules hold as in the JAX
package. Every experiment uses ``hb_interval`` 0.05 or less.
"""

import json
import os
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maggy_tpu_torch
from maggy_tpu import Searchspace as JSpace
from maggy_tpu import experiment as j_experiment
from maggy_tpu.config import AblationConfig as JAblationConfig
from maggy_tpu.config import HyperparameterOptConfig as JHPOConfig
from maggy_tpu.models import MLP as JMLP
from maggy_tpu_torch import Searchspace, experiment
from maggy_tpu_torch.config import BaseConfig, DistributedConfig, HyperparameterOptConfig
from maggy_tpu_torch.convert import mlp_params_from_flax
from maggy_tpu_torch.core.driver.base import device_groups
from maggy_tpu_torch.exceptions import BroadcastMetricTypeError
from maggy_tpu_torch.models import MLP, Decoder, DecoderConfig
from maggy_tpu_torch.optimizer import Asha
from maggy_tpu_torch.parallel import ShardingSpec
from maggy_tpu_torch.reporter import Reporter
from maggy_tpu_torch.train import Trainer, adamw, classification_loss_fn, synthetic_lm_batches

torch.set_num_threads(2)
HB = 0.05


@pytest.fixture()
def port_env(tmp_path):
    """Point the port's ambient Env at a per-test temp dir (the JAX side's
    ``tmp_env`` fixture does the same for the JAX package)."""
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract is not observable here")


def _lagom(train_fn, config, lagom=experiment.lagom, timeout=120.0):
    """``lagom`` (the port's unless another is given) on a thread, waited for
    under a timeout; its result is returned and its exception raised here."""
    out = {}

    def run():
        try:
            out["result"] = lagom(train_fn, config)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            out["error"] = e

    thread = threading.Thread(target=run, name="lagom-under-test", daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), f"lagom did not return within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def _executor_threads():
    return [t for t in threading.enumerate() if t.name.startswith("maggy-executor")]


def _space(mod):
    return mod(x=("DOUBLE", [0.0, 1.0]), y=("DOUBLE", [0.0, 1.0]))


def _trials(env, exp_module):
    """{trial_id: (status, final_metric)} of the last experiment's trial.json files."""
    exp_dir = env.experiment_dir(exp_module.APP_ID, exp_module.RUN_ID)
    out = {}
    for name in os.listdir(exp_dir):
        path = os.path.join(exp_dir, name, "trial.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            out[rec["trial_id"]] = (rec["status"], rec["final_metric"])
    return out


def _metric_only(hparams, reporter):
    base = hparams["x"] * (1 - hparams["y"])
    for step in range(3):
        reporter.broadcast(base + 0.01 * step, step=step)
    return base + 0.02


def test_randomsearch_matches_jax_lagom(tmp_env, port_env):
    kw = dict(num_trials=6, optimizer="randomsearch", direction="max", num_executors=1,
              es_policy="none", hb_interval=HB, seed=0)
    want = _lagom(_metric_only, JHPOConfig(searchspace=_space(JSpace), **kw), lagom=j_experiment.lagom)
    got = _lagom(_metric_only, HyperparameterOptConfig(searchspace=_space(Searchspace), device="cpu", **kw))
    trials = _trials(port_env, experiment)
    assert len(trials) == 6 and trials == _trials(tmp_env, j_experiment)
    for key in ("best", "worst"):
        assert {k: v for k, v in got[key].items()} == want[key]
    assert got["avg"] == want["avg"] and got["num_trials"] == want["num_trials"] == 6
    assert got["errors"] == want["errors"] == 0
    assert _executor_threads() == []


def _train_decoder(hparams, reporter, devices, budget):
    cfg = DecoderConfig.tiny()
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(hparams["lr"]), device=devices[0])
    data = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=0)
    state = trainer.make_state(0, next(data))
    assert all(p.device == devices[0] for p in state.model.parameters())
    _, metrics = trainer.fit(state, data, int(budget), reporter=reporter, report_every=1, metrics_window=0)
    return metrics["loss"]


def test_asha_trains_the_decoder(port_env):
    budgets = []

    def train(hparams, reporter, devices, budget):
        budgets.append(budget)
        return _train_decoder(hparams, reporter, devices, budget)

    cfg = HyperparameterOptConfig(
        num_trials=4, optimizer=Asha(reduction_factor=2, resource_min=1, resource_max=2, seed=0),
        searchspace=Searchspace(lr=("DOUBLE", [1e-3, 3e-2])), direction="min",
        es_policy="none", hb_interval=HB, device="cpu",
    )
    result = _lagom(train, cfg)
    trials = _trials(port_env, experiment)
    assert result["errors"] == 0 and len(trials) == result["num_trials"] > 4
    assert all(status == "FINALIZED" for status, _ in trials.values())
    assert sorted(set(budgets)) == [1, 2] and budgets.count(2) >= 1  # a promotion ran

    class Quiet:
        def broadcast(self, value, step=None):
            pass

    best = result["best"]
    again = _train_decoder(best["params"], Quiet(), [torch.device("cpu")], best["params"]["budget"])
    assert best["metric"] == again


def test_baseline_config1_mlp_single_run(port_env):
    """BASELINE config 1: the port's MLP from converted flax params gives the
    JAX MLP's logits (fp32, atol 1e-5), then trains a few steps, under a
    single-run ``lagom``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, (8,)).astype(np.int64)
    jmodel = JMLP(features=(32, 16), num_classes=10)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    params = mlp_params_from_flax(jax.device_get(variables), 2)

    def train(devices, reporter):
        model = MLP(28 * 28, features=(32, 16), num_classes=10, device=devices[0])
        model.load_state_dict(params)
        with torch.no_grad():
            logits = model(torch.from_numpy(x))
        trainer = Trainer(model, adamw(1e-2), device=devices[0], loss_fn=classification_loss_fn)
        batch = {"inputs": x, "labels": labels}
        state = trainer.make_state(0, batch, params=params)
        _, metrics = trainer.fit(state, iter([batch] * 3), 3, reporter=reporter, report_every=1, metrics_window=0)
        return {"metric": metrics["loss"], "logits": logits}

    result = _lagom(train, BaseConfig(hb_interval=HB, device="cpu"))
    np.testing.assert_allclose(np.asarray(result["logits"], np.float32), want, atol=1e-5, rtol=0)
    assert np.isfinite(result["metric"])


def test_mlp_init_draws_he_normal():
    model = MLP(512, features=(256,), num_classes=10, device="cpu", generator=torch.Generator().manual_seed(0))
    w = model.dense_0.weight.detach()
    assert float(w.std()) == pytest.approx((2.0 / 512) ** 0.5, rel=0.05)
    assert float(w.abs().max()) <= 2 * (2.0 / 512) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(model.head.bias.detach().abs().max()) == 0.0


def test_early_stopping(port_env):
    def train(hparams, reporter):
        for step in range(200):
            reporter.broadcast(hparams["x"], step=step)
            time.sleep(0.002)
        return hparams["x"]

    cfg = HyperparameterOptConfig(
        num_trials=6, optimizer="randomsearch", searchspace=_space(Searchspace), direction="max",
        num_executors=2, es_policy="median", es_interval=0, es_min=2, hb_interval=0.02, seed=11,
        device="cpu",
    )
    result = _lagom(train, cfg)
    assert result["num_trials"] == 6 and result["early_stopped"] > 0


@pytest.mark.parametrize("fail_on", ["every", "third"])
def test_failing_train_fn(port_env, fail_on):
    """A train_fn that fails before any success aborts the experiment; once
    a trial has succeeded, a sporadic failure is recorded and tolerated."""
    calls = []

    def train(hparams):
        calls.append(hparams)
        if fail_on == "every" or len(calls) == 3:
            raise ValueError("broken train fn")
        return hparams["x"]

    cfg = HyperparameterOptConfig(
        num_trials=5, optimizer="randomsearch", searchspace=_space(Searchspace), num_executors=1,
        es_policy="none", hb_interval=HB, seed=2, device="cpu",
    )
    if fail_on == "every":
        with pytest.raises(RuntimeError, match="broken train fn"):
            _lagom(train, cfg)
    else:
        result = _lagom(train, cfg)
        assert result["num_trials"] == 5 and result["errors"] == 1
    assert _executor_threads() == []


def test_resume_from(port_env):
    calls = []

    def train(hparams):
        calls.append(hparams["x"])
        return hparams["x"]

    kw = dict(optimizer="randomsearch", searchspace=_space(Searchspace), num_executors=1,
              es_policy="none", hb_interval=HB, seed=42, device="cpu")
    _lagom(train, HyperparameterOptConfig(num_trials=3, **kw))
    first = list(calls)
    first_dir = port_env.experiment_dir(experiment.APP_ID, experiment.RUN_ID)
    calls.clear()
    result = _lagom(train, HyperparameterOptConfig(num_trials=6, resume_from=first_dir, **kw))
    assert result["num_trials"] == 6  # 3 preloaded + 3 new
    assert len(calls) == 3 and not set(calls) & set(first)
    with pytest.raises(FileNotFoundError):
        _lagom(train, HyperparameterOptConfig(num_trials=2, resume_from=first_dir + "-missing", **kw))


@pytest.mark.parametrize("sharding", [None, "fsdp", ShardingSpec(sp=2)], ids=["default-dp", "fsdp", "sp2"])
def test_devices_and_ctx(port_env, sharding):
    """``devices`` is the lease, ``[torch.device("cpu")]``; ``ctx`` is a
    LocalRing for ``sp > 1`` and raises, as the trial's error, for every
    preset the port lacks."""
    seen = []

    def train(devices, ctx):
        seen.append((devices, ctx.ring.size, ctx.device))
        return 1.0

    cfg = HyperparameterOptConfig(
        num_trials=1, optimizer="randomsearch", searchspace=_space(Searchspace),
        es_policy="none", hb_interval=HB, device="cpu", sharding=sharding,
    )
    if isinstance(sharding, ShardingSpec):
        _lagom(train, cfg)
        assert seen == [([torch.device("cpu")], 2, torch.device("cpu"))]
    else:
        # the driver aborts on the first trial's error, which it names
        with pytest.raises(RuntimeError, match="First trial.*NotImplementedError.*ROADMAP queue 1 item 7"):
            _lagom(train, cfg)
        assert seen == []


def test_executor_keeps_no_reference_to_a_finished_trial(port_env):
    """Trials run back to back on one lease: when the next starts, nothing of
    the last one (its model, return value, outputs) is held any more."""
    refs, alive_at_start = [], []

    class Big(dict):
        pass

    def train(hparams, devices):
        alive_at_start.append([r() is not None for r in refs])
        model = torch.nn.Linear(64, 64, device=devices[0])
        out = Big(metric=hparams["x"])
        refs.extend([weakref.ref(model), weakref.ref(out)])
        return out

    cfg = HyperparameterOptConfig(
        num_trials=3, optimizer="randomsearch", searchspace=_space(Searchspace), num_executors=1,
        es_policy="none", hb_interval=HB, seed=1, device="cpu",
    )
    _lagom(train, cfg)
    assert alive_at_start == [[], [False, False], [False] * 4]
    assert [r() for r in refs] == [None] * 6


@pytest.mark.parametrize(
    "metric",
    [torch.tensor(1.0), torch.tensor([1.0]), torch.tensor(2, dtype=torch.int64)],
    ids=["0-d", "1-d", "int"],
)
def test_broadcast_rejects_a_tensor(metric):
    """Same type check as the JAX package's (which rejects a jax array): the
    port adds no tensor coercion."""
    with pytest.raises(BroadcastMetricTypeError):
        Reporter().broadcast(metric, step=0)
    from maggy_tpu.exceptions import BroadcastMetricTypeError as JError
    from maggy_tpu.reporter import Reporter as JReporter

    with pytest.raises(JError):
        JReporter().broadcast(jnp.asarray(metric.numpy()), step=0)


def test_no_cuda_and_no_device_raises_before_anything_starts(port_env, no_cuda):
    before = set(threading.enumerate())
    for cfg in (
        HyperparameterOptConfig(num_trials=2, optimizer="randomsearch", searchspace=_space(Searchspace),
                                es_policy="none", hb_interval=HB),
        BaseConfig(hb_interval=HB),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _lagom(lambda hparams: 1.0, cfg)
    assert set(threading.enumerate()) <= before
    assert not os.path.exists(port_env.root)  # no experiment directory either
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_groups(1)


def test_device_groups():
    assert device_groups(1, "cpu") == [[torch.device("cpu")]]
    assert device_groups(4, "cpu") == [[torch.device("cpu")]]
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        device_groups(1, "cuda:1")
    with pytest.raises(ValueError, match="CPU or all visible CUDA cards"):
        device_groups(1, "meta")


@pytest.mark.parametrize(
    "make, match",
    [
        # elastic membership is ported (tests/test_torch_elastic.py): what
        # the JAX package refuses, the port refuses with JAX's own errors,
        # before any rank starts: a floor above the launch width, and a
        # pod of one rank cut into two slices (JAX's "do not split")
        (lambda: DistributedConfig(device="cpu", elastic=True, min_slices=2),
         r"min_slices=2 exceeds the launch width \(1 slice\(s\)\)"),
        (lambda: DistributedConfig(device="cpu", driver_addr="localhost:1", elastic=True, num_slices=2),
         "1 ranks do not split into 2 equal slices"),
    ],
    ids=["distributed", "pod-driver-addr"],
)
def test_unported_experiment_kinds_raise(port_env, make, match):
    with pytest.raises(ValueError, match=match):
        _lagom(lambda hparams: 1.0, make())


def test_ablation_config_dispatches_to_ablation_driver(port_env):
    """Ablation is ported: ``AblationConfig`` selects the ``AblationDriver``
    (an HPO driver over a LOCO controller, no early stopping)."""
    from maggy_tpu_torch.ablation import AblationStudy
    from maggy_tpu_torch.config import AblationConfig
    from maggy_tpu_torch.core.driver.ablation import AblationDriver, AblatorController
    from maggy_tpu_torch.earlystop import NoStoppingRule

    study = AblationStudy()
    study.model.layers.include("mlp")
    driver = experiment.lagom_driver(AblationConfig(study, device="cpu", hb_interval=HB), "app", 0)
    try:
        assert isinstance(driver, AblationDriver) and isinstance(driver.controller, AblatorController)
        assert driver.num_trials == 2 and driver.earlystop is NoStoppingRule
        assert driver.controller.name() == "LOCO"
    finally:
        driver.telemetry.close()
    with pytest.raises(TypeError, match="Unsupported config type"):
        # the JAX package's own config is no port config
        experiment.lagom_driver(JAblationConfig.__new__(JAblationConfig), "app", 0)


@pytest.mark.parametrize("var, value, match", [
    ("MAGGY_TPU_ROLE", "worker", "no driver address"),
    ("MAGGY_TPU_DRIVER", "localhost:1", "needs MAGGY_TPU_SECRET"),
], ids=["MAGGY_TPU_ROLE-worker-item 7", "MAGGY_TPU_DRIVER-localhost:1-item 7"])
def test_pod_workers_raise(port_env, monkeypatch, var, value, match):
    """Pod workers are ported (tests/test_torch_pod*.py); a worker without
    a driver address or a secret raises before it connects, as the JAX
    package's does."""
    monkeypatch.setenv("MAGGY_TPU_ROLE", "worker")
    monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match=match):
        _lagom(lambda hparams: 1.0, BaseConfig(device="cpu", hb_interval=HB))


def test_cloud_log_root_raises(monkeypatch):
    from maggy_tpu_torch.core import env as env_mod

    env_mod.set_instance(None)
    monkeypatch.setenv("MAGGY_TPU_LOG_ROOT", "gs://bucket/experiments")
    try:
        with pytest.raises(NotImplementedError, match="item 9"):
            env_mod.get_instance()
    finally:
        env_mod.set_instance(None)


def test_package_exports():
    assert maggy_tpu_torch.experiment is experiment
    assert {"Searchspace", "Trial", "Reporter"} <= set(maggy_tpu_torch.__all__)
