"""The port's ablation experiment against the JAX package's, on the CPU.

The study spec, the LOCO ablator, the dataset generator, the resolver and
``auto_ablate`` are held to the JAX package's on the same inputs: equal
trial lists, markers, trial ids and errors. ``ParamMaskedModel`` is held to
JAX's on the same (converted) weights and keeps its masked parameters and
their gradients at zero through ``torch.optim.AdamW`` steps. Two whole
studies run under both packages' ``lagom`` (``AblationConfig(device="cpu")``
on the port's side): LOCO over a tiny BERT (3 components, 1 feature), each
trial from the flax init of its own variant, converted, taking the same SGD
steps on the same batch; and the zero-factory Decoder study of
``tests/test_ablation_factory_free.py::test_loco_lagom_zero_factories``.

Tolerances, fp32 throughout: the masked MLP's outputs 1e-6 absolute (the
same two small products); a trial's final loss after 5 SGD steps 1e-4
relative (measured 0 to 1.2e-5, the largest where the pooler-less
variant's loss climbs to 4.3); the Decoder study's mean |logit| 1e-5
relative (measured at most 1.2e-7).
"""

import json
import os
import threading

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu import experiment as j_experiment
from maggy_tpu.ablation import AblationStudy as JStudy
from maggy_tpu.ablation.ablationstudy import default_dataset_generator as j_generator
from maggy_tpu.ablation.ablator import LOCO as JLOCO
from maggy_tpu.ablation.masking import ParamMaskedModel as JMasked
from maggy_tpu.config import AblationConfig as JAblationConfig
from maggy_tpu.core.driver.ablation import make_ablation_resolver as j_resolver
from maggy_tpu.models import bert as jb
from maggy_tpu.models import transformer as jt
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch import experiment
from maggy_tpu_torch.ablation import AblationStudy
from maggy_tpu_torch.ablation.ablationstudy import default_dataset_generator
from maggy_tpu_torch.ablation.ablator import LOCO
from maggy_tpu_torch.ablation.masking import ParamMaskedModel, auto_ablate, fresh, rebuild
from maggy_tpu_torch.config import AblationConfig
from maggy_tpu_torch.convert import bert_params_from_flax, decoder_params_from_flax
from maggy_tpu_torch.core.driver.ablation import AblationDriver, _make_ablator, make_ablation_resolver
from maggy_tpu_torch.models import Bert, BertConfig, Decoder, DecoderConfig

torch.set_num_threads(2)
HB = 0.05
SGD_LR, SGD_STEPS = 0.3, 5
LOSS_RTOL = 1e-4
DECODER_RTOL = 1e-5


@pytest.fixture()
def port_env(tmp_path):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


def _lagom(train_fn, config, lagom=experiment.lagom, timeout=120.0):
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


def _trials(env, exp_module):
    """{trial_id: (params, status, final_metric)} of the last experiment."""
    exp_dir = env.experiment_dir(exp_module.APP_ID, exp_module.RUN_ID)
    out = {}
    for name in os.listdir(exp_dir):
        path = os.path.join(exp_dir, name, "trial.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            out[rec["trial_id"]] = (rec["params"], rec["status"], rec["final_metric"])
    return out


def _study(mod):
    s = mod()
    s.features.include("f1", "f2")
    s.model.layers.include("block_a", "block_b", "head_extra")
    s.model.layers.include_groups(["block_a", "block_b"])
    s.model.layers.include_groups(["head_extra", "block_b"])
    s.model.layers.include_groups(prefix="head_")
    s.model.add_custom_generator("wide", lambda: "wide-model")
    s.model.add_custom_generator("narrow", lambda: "narrow-model")
    return s


def _drain(ablator):
    ablator.initialize()
    out = []
    while (t := ablator.get_trial()) is not None:
        out.append(t)
    return out


# ------------------------------------------------------------ study, ablator


def test_study_and_loco_enumerate_as_jax():
    want, got = _study(JStudy), _study(AblationStudy)
    assert got.to_dict() == want.to_dict()
    jl, tl = JLOCO(want), LOCO(got)
    assert tl.get_number_of_trials() == jl.get_number_of_trials() == 1 + 2 + 3 + 3 + 2
    jt_, tt_ = _drain(jl), _drain(tl)
    assert [t.params for t in tt_] == [t.params for t in jt_]
    assert [t.trial_id for t in tt_] == [t.trial_id for t in jt_]
    assert {t.trial_type for t in tt_} == {"ablation"}
    comps = [t.params["ablated_component"] for t in tt_]
    # baseline, features, components, groups, custom generators
    assert tt_[0].params == {"ablated_feature": "None", "ablated_component": "None"}
    assert [t.params["ablated_feature"] for t in tt_[1:3]] == ["f1", "f2"]
    assert comps[3:] == ["block_a", "block_b", "head_extra", "block_a|block_b", "block_b|head_extra",
                         "head_extra", "custom:narrow", "custom:wide"]


@pytest.mark.parametrize("call", [
    lambda s: s.model.layers.include_groups(prefix="nope_"),
    lambda s: s.model.layers.include_groups([]),
    lambda s: s.model.layers.include_groups(["a"], prefix="a"),
    lambda s: s.features.include(3),
    lambda s: s.model.layers.include(None),
])
def test_study_errors_match_jax(call):
    def err(mod):
        s = mod()
        try:
            call(s)
            s.model.layers.included_groups
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e), str(e)
        return None

    want = err(JStudy)
    assert want is not None and err(AblationStudy) == want


# ---------------------------------------------------------- dataset generator


def _error(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


def test_default_dataset_generator_dict_as_jax():
    ds = {"f1": np.zeros(4), "f2": np.ones(4), "label": np.ones(4)}
    assert set(default_dataset_generator(ds, "f1")) == set(j_generator(ds, "f1")) == {"f2", "label"}
    assert default_dataset_generator(ds, None) is ds and default_dataset_generator(None, "f1") is None
    for args in ((ds, "missing"), ([1, 2], "f1")):
        want = _error(j_generator, *args)
        assert want is not None and _error(default_dataset_generator, *args) == want


def test_default_dataset_generator_sharded_datasets(tmp_path):
    from maggy_tpu_torch.train.sharded_dataset import (
        ParquetShardedDataset,
        ShardedDataset,
        write_parquet,
        write_sharded,
    )

    data = {
        "tokens": np.arange(32, dtype=np.int32).reshape(8, 4),
        "extra": np.arange(8, dtype=np.int64),
    }
    write_sharded(str(tmp_path / "npy"), data, num_shards=2)
    ds = ShardedDataset(str(tmp_path / "npy"))
    dropped = default_dataset_generator(ds, "extra")
    assert isinstance(dropped, ShardedDataset) and dropped.fields == ["tokens"]
    assert next(dropped.loader(4, loop=False, shuffle=False)).keys() == {"tokens"}
    with pytest.raises(KeyError, match="not in dataset fields"):
        default_dataset_generator(ds, "nope")
    with pytest.raises(ValueError, match="only field"):
        default_dataset_generator(dropped, "tokens")

    pytest.importorskip("pyarrow")
    write_parquet(str(tmp_path / "pq"), data, rows_per_group=4)
    pq_dropped = default_dataset_generator(ParquetShardedDataset(str(tmp_path / "pq")), "extra")
    assert isinstance(pq_dropped, ParquetShardedDataset) and pq_dropped.fields == ["tokens"]


# ------------------------------------------------------------------ masking


class _JPlainMLP(nn.Module):
    @nn.compact
    def __call__(self, x):
        h = nn.Dense(8, name="hidden")(x)
        x = x + nn.Dense(x.shape[-1], name="proj")(nn.relu(h))
        return nn.Dense(2, name="head")(x)


class _PlainMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = torch.nn.Linear(4, 8)
        self.proj = torch.nn.Linear(8, 4)
        self.head = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.head(x + self.proj(torch.relu(self.hidden(x))))


def _converted_mlp(params):
    model = _PlainMLP()
    model.load_state_dict({
        f"{name}.{k}": torch.from_numpy(np.array(params[name]["kernel" if k == "weight" else "bias"])).T
        if k == "weight" else torch.from_numpy(np.array(params[name]["bias"]))
        for name in ("hidden", "proj", "head") for k in ("weight", "bias")
    })
    return model


def test_param_masked_model_matches_jax_and_zeroes_grads():
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    variables = JMasked(_JPlainMLP(), {"proj"}).init(jax.random.key(0), jnp.asarray(x))
    params = _JPlainMLP().init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(JMasked(_JPlainMLP(), {"proj"}).apply(variables, jnp.asarray(x)))

    masked = ParamMaskedModel(_converted_mlp(jax.device_get(params)), {"proj"})
    assert masked.masked == ("proj.weight", "proj.bias")
    out = masked(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-6)
    out.sum().backward()
    assert all(float(p.grad.abs().max()) == 0.0 for p in masked.base.proj.parameters())
    assert float(masked.base.head.weight.grad.abs().max()) > 0.0

    for mod, cls in ((_JPlainMLP(), JMasked), (_PlainMLP(), ParamMaskedModel)):
        with pytest.raises(ValueError, match="no parameter subtree"):
            m = cls(mod, {"nonexistent"})
            if cls is JMasked:
                m.init(jax.random.key(0), jnp.asarray(x))


def test_param_masked_model_stays_zero_through_adamw():
    torch.manual_seed(0)
    masked = ParamMaskedModel(_PlainMLP(), {"proj"})
    head0 = masked.base.head.weight.detach().clone()
    opt = torch.optim.AdamW(masked.parameters(), lr=1e-2, weight_decay=1e-2)
    x = torch.randn(16, 4)
    for _ in range(5):
        opt.zero_grad()
        masked(x).square().mean().backward()
        assert all(float(p.grad.abs().max()) == 0.0 for p in masked.base.proj.parameters())
        opt.step()
    assert all(float(p.detach().abs().max()) == 0.0 for p in masked.base.proj.parameters())
    assert not torch.equal(masked.base.head.weight, head0)
    # a re-initialisation (Trainer.make_state's) is zeroed again at the next forward
    with torch.no_grad():
        masked.base.proj.weight.fill_(1.0)
        masked(x)
    assert float(masked.base.proj.weight.detach().abs().max()) == 0.0


def test_param_masked_model_matches_dotted_segments():
    m = ParamMaskedModel(Decoder(DecoderConfig.tiny(), device="meta"), {"layers.1.mlp", "final_norm"})
    assert set(m.masked) == {"layers.1.mlp.w_gate.weight", "layers.1.mlp.w_up.weight",
                             "layers.1.mlp.w_down.weight", "final_norm.scale"}
    assert m.cfg is m.base.cfg  # attributes the wrapper lacks come from the base


def test_auto_ablate_tiers_keep_device_and_never_return_the_base():
    # tier 1: config with without(); a meta base gives a meta variant
    base = Decoder(DecoderConfig.tiny(), device="meta")
    m = auto_ablate(base, frozenset({"mlp"}))
    assert isinstance(m, Decoder) and m is not base and m.cfg.ablated == frozenset({"mlp"})
    assert all(p.is_meta for p in m.parameters()) and base.cfg.ablated == frozenset()
    # tier 2: config with an ablated field, merged
    b = auto_ablate(Bert(BertConfig.tiny(ablated={"layer_1"}), device="meta"), frozenset({"pooler"}))
    assert isinstance(b, Bert) and b.cfg.ablated == frozenset({"pooler", "layer_1"}) and b.pooler is None
    # tier 3: plain module -> masking wrapper over a copy
    plain = _PlainMLP()
    p = auto_ablate(plain, frozenset({"hidden"}))
    assert isinstance(p, ParamMaskedModel) and p.base is not plain
    assert float(plain.hidden.weight.abs().max()) > 0  # the base is not zeroed
    # the JAX tiers give the same kinds and configs
    jm = __import__("maggy_tpu.ablation.masking", fromlist=["auto_ablate"]).auto_ablate
    assert jm(jt.Decoder(jt.DecoderConfig.tiny()), frozenset({"mlp"})).cfg.ablated == m.cfg.ablated
    assert jm(jb.Bert(jb.BertConfig.tiny(ablated=frozenset({"layer_1"}))),
              frozenset({"pooler"})).cfg.ablated == b.cfg.ablated
    # a rebuild keeps the device and draws fresh weights there
    cpu = Decoder(DecoderConfig.tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
    again = rebuild(cpu)
    assert again is not cpu and all(q.device.type == "cpu" for q in again.parameters())
    assert fresh("not-a-module") == "not-a-module"
    assert isinstance(fresh(plain), _PlainMLP) and fresh(plain) is not plain


def test_decoder_gates_zero_the_ablated_gradients():
    """The port's Decoder (the flash kernels' plain versions on the CPU):
    ``layers.0.attn`` gated gives exactly zero gradients to layer 0's
    attention and not to layer 1's, as the JAX test does."""
    cfg = DecoderConfig.tiny(dtype=torch.float32).without("layers.0.attn")
    model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    model(tokens).sum().backward()
    for name, p in model.layers[0].attn.named_parameters():
        assert float(p.grad.abs().max()) == 0.0, name
    for name, p in model.layers[1].attn.named_parameters():
        assert float(p.grad.abs().max()) > 0.0, name


# ---------------------------------------------------------------- resolver


def _available(model=None, dataset=None):
    return {"hparams": {"ablated_feature": "f1", "ablated_component": "None", "lr": 0.1},
            "reporter": None, "model": model, "dataset": dataset, "devices": [], "trial_dir": "",
            "budget": None}


def test_resolver_markers_and_dataset_match_jax():
    ds = {"f1": np.zeros(2), "f2": np.ones(2)}
    params = {"ablated_feature": "f1", "ablated_component": "None"}
    want = j_resolver(JStudy())(params, _available(dataset=ds))
    got = make_ablation_resolver(AblationStudy())(params, _available(dataset=ds))
    assert got["hparams"] == want["hparams"] == {"lr": 0.1}
    assert (got["ablated_feature"], got["ablated_component"]) == (want["ablated_feature"],
                                                                  want["ablated_component"]) == ("f1", None)
    assert set(got["dataset"]) == set(want["dataset"]) == {"f2"}


def test_resolver_factory_custom_and_missing_model_as_jax():
    calls = []
    for mod, store in ((JStudy, []), (AblationStudy, calls)):
        s = mod()
        s.model.set_factory(lambda ablated, store=store: store.append(ablated) or f"model-{sorted(ablated)}")
        s.model.add_custom_generator("wide", lambda: "wide-model")
        r = (j_resolver if mod is JStudy else make_ablation_resolver)(s)
        assert r({"ablated_component": "a|b"}, _available())["model"] == "model-['a', 'b']"
        assert r({"ablated_component": "custom:wide"}, _available())["model"] == "wide-model"
        assert r({"ablated_component": "None"}, _available())["model"] == "model-[]"
    assert calls == [frozenset({"a", "b"}), frozenset()]
    want = _error(j_resolver(JStudy()), {"ablated_component": "mlp"}, _available())
    assert want is not None
    assert _error(make_ablation_resolver(AblationStudy()), {"ablated_component": "mlp"}, _available()) == want


def test_every_trial_gets_a_model_no_trial_trained():
    base = Decoder(DecoderConfig.tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in base.state_dict().items()}
    resolve = make_ablation_resolver(AblationStudy())
    seen = []
    for comp in ("None", "mlp", "None"):
        model = resolve({"ablated_component": comp}, _available(model=base))["model"]
        assert model is not base and all(m is not model for m in seen)
        assert all(p.device.type == "cpu" for p in model.parameters())
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)  # "training"
        seen.append(model)
    assert all(torch.equal(v, before[k]) for k, v in base.state_dict().items())
    assert seen[1].cfg.ablated == frozenset({"mlp"}) and seen[0].cfg.ablated == frozenset()


# ------------------------------------------------------------ config, driver


def test_config_checks_and_ablator_choice_as_jax():
    for mod in (JAblationConfig, AblationConfig):
        with pytest.raises(ValueError, match="direction must be"):
            mod(AblationStudy(), direction="up")
    assert AblationConfig(AblationStudy(), device="cpu").device == "cpu"
    cfg = AblationConfig(AblationStudy())
    assert isinstance(_make_ablator(cfg), LOCO)
    cfg.ablator = "nope"
    with pytest.raises(ValueError, match="Unknown ablator"):
        _make_ablator(cfg)
    cfg.ablator = 3
    with pytest.raises(TypeError, match="ablator must be"):
        _make_ablator(cfg)
    with pytest.raises(TypeError, match="must be an AblationStudy"):
        AblationDriver(AblationConfig("not-a-study", device="cpu"), "app", 0)


def test_ablation_needs_cuda_unless_told(port_env):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract is not observable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _lagom(lambda: 1.0, AblationConfig(AblationStudy(), hb_interval=HB))
    assert not os.path.exists(port_env.root)  # nothing created


# ------------------------------------------------------------ whole studies

B, S = 4, 16


def _bert_data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 256, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    mask[3, 4:] = 0
    return {"tokens": tokens, "attention_mask": mask, "label": rng.integers(0, 2, (B,)).astype(np.int32)}


def _bert_study(mod):
    s = mod()
    s.features.include("attention_mask")
    s.model.layers.include("layer_0", "pooler", "position_embeddings")
    return s


def _jax_bert_train(model, dataset, reporter):
    tokens = jnp.asarray(dataset["tokens"])
    mask = dataset.get("attention_mask")
    mask = None if mask is None else jnp.asarray(mask)
    labels = jnp.asarray(dataset["label"])
    params = model.init(jax.random.key(0), tokens, mask)["params"]

    def loss_fn(p):
        logits, _ = model.apply({"params": p}, tokens, mask)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], 1).mean()

    for _ in range(SGD_STEPS):
        params = jax.tree.map(lambda a, g: a - SGD_LR * g, params, jax.grad(loss_fn)(params))
    loss = float(loss_fn(params))
    reporter.broadcast(loss, step=0)
    return loss


def _port_bert_train(model, dataset, reporter, devices):
    """The same steps on the port's variant, from the flax init of the same
    variant (the port's model arrives on the meta device)."""
    cfg = model.cfg
    tokens = jnp.asarray(dataset["tokens"])
    mask = dataset.get("attention_mask")
    jcfg = jb.BertConfig.tiny(dtype=jnp.float32, ablated=cfg.ablated)
    flax_params = jb.Bert(jcfg).init(jax.random.key(0), tokens, None if mask is None else jnp.asarray(mask))
    assert all(p.is_meta for p in model.parameters())
    model.to_empty(device=devices[0])
    model.load_state_dict(bert_params_from_flax(jax.device_get(unbox(flax_params["params"])), cfg))
    t_tokens = torch.from_numpy(dataset["tokens"])
    t_mask = None if mask is None else torch.from_numpy(mask)
    labels = torch.from_numpy(dataset["label"]).long()
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)

    def loss_fn():
        logits, _ = model(t_tokens, t_mask)
        return -torch.log_softmax(logits, -1).gather(-1, labels[:, None]).mean()

    for _ in range(SGD_STEPS):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    with torch.no_grad():
        loss = float(loss_fn())
    reporter.broadcast(loss, step=0)
    return loss


def test_bert_loco_study_matches_jax_lagom(tmp_env, port_env):
    data = _bert_data()
    jcfg = JAblationConfig(ablation_study=_bert_study(JStudy), model=jb.Bert(jb.BertConfig.tiny(dtype=jnp.float32)),
                           dataset=data, direction="min", hb_interval=HB)
    want = _lagom(_jax_bert_train, jcfg, lagom=j_experiment.lagom)
    tcfg = AblationConfig(ablation_study=_bert_study(AblationStudy),
                          model=Bert(BertConfig.tiny(dtype=torch.float32), device="meta"),
                          dataset=data, direction="min", hb_interval=HB, device="cpu")
    got = _lagom(_port_bert_train, tcfg)
    jtrials, ttrials = _trials(tmp_env, j_experiment), _trials(port_env, experiment)
    assert got["num_trials"] == want["num_trials"] == 5 and got["errors"] == want["errors"] == 0
    assert ttrials.keys() == jtrials.keys()
    for tid, (params, status, metric) in ttrials.items():
        jparams, jstatus, jmetric = jtrials[tid]
        assert params == jparams and status == jstatus == "FINALIZED"
        assert metric == pytest.approx(jmetric, rel=LOSS_RTOL), params
    assert got["best"]["params"] == want["best"]["params"]


def test_decoder_zero_factory_study_matches_jax_lagom(tmp_env, port_env):
    """``test_loco_lagom_zero_factories`` under both packages: no factory,
    the variants derived from the config model (``cfg.without``)."""
    jcfg = jt.DecoderConfig.tiny(dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    j_seen, t_seen = [], []

    def j_train(model, reporter):
        params = model.init(jax.random.key(0), tokens)["params"]
        j_seen.append(model.cfg.ablated)
        metric = float(jnp.abs(model.apply({"params": params}, tokens)).mean())
        reporter.broadcast(metric, step=0)
        return metric

    def t_train(model, reporter, devices):
        # the flax init of the same variant (a gate leaves the tree as it is)
        jmodel = jt.Decoder(jt.DecoderConfig.tiny(dtype=jnp.float32, ablated=model.cfg.ablated))
        params = jax.device_get(unbox(jmodel.init(jax.random.key(0), tokens)["params"]))
        model.to_empty(device=devices[0])
        model.load_state_dict(decoder_params_from_flax(params, model.cfg))
        t_seen.append(model.cfg.ablated)
        with torch.no_grad():
            metric = float(model(torch.from_numpy(tokens)).abs().mean())
        reporter.broadcast(metric, step=0)
        return metric

    def study(mod):
        s = mod()
        s.model.layers.include("mlp", "layers.0")
        return s

    want = _lagom(j_train, JAblationConfig(ablation_study=study(JStudy), model=jt.Decoder(jcfg),
                                           direction="max", hb_interval=HB), lagom=j_experiment.lagom)
    got = _lagom(t_train, AblationConfig(ablation_study=study(AblationStudy),
                                         model=Decoder(DecoderConfig.tiny(dtype=torch.float32), device="meta"),
                                         direction="max", hb_interval=HB, device="cpu"))
    assert got["num_trials"] == want["num_trials"] == 3
    assert sorted(map(sorted, t_seen)) == sorted(map(sorted, j_seen)) == [[], ["layers.0"], ["mlp"]]
    jtrials, ttrials = _trials(tmp_env, j_experiment), _trials(port_env, experiment)
    assert ttrials.keys() == jtrials.keys()
    for tid, (params, _, metric) in ttrials.items():
        assert params == jtrials[tid][0]
        assert metric == pytest.approx(jtrials[tid][2], rel=DECODER_RTOL), params
