"""The port's HPO pieces against the JAX package's, decision for decision.

``maggy_tpu_torch`` keeps its own copies of ``Searchspace``, ``Trial``, the
optimizers, the Hyperband pruner and the early-stop rules. Both packages get
the same seeds and the same scripted sequence of finalized trials, and every
check is exact: the same samples, the same trial ids, the same suggestions,
promotions and stops in the same order.
"""

import random

import numpy as np
import pytest
import torch

import maggy_tpu.earlystop as j_es
import maggy_tpu.optimizer as j_opt
import maggy_tpu.pruner.hyperband as j_hb
import maggy_tpu_torch.earlystop as t_es
import maggy_tpu_torch.optimizer as t_opt
import maggy_tpu_torch.pruner.hyperband as t_hb
from maggy_tpu import Searchspace as JSpace
from maggy_tpu import Trial as JTrial
from maggy_tpu.optimizer.bayes import GP as JGP
from maggy_tpu.optimizer.bayes import TPE as JTPE
from maggy_tpu_torch import Searchspace as TSpace
from maggy_tpu_torch import Trial as TTrial
from maggy_tpu_torch.optimizer.bayes import GP as TGP
from maggy_tpu_torch.optimizer.bayes import TPE as TTPE

SPACE = dict(
    lr=("DOUBLE", [1e-4, 1e-1]),
    width=("INTEGER", [8, 64]),
    act=("CATEGORICAL", ["relu", "gelu", "silu"]),
    batch=("DISCRETE", [16, 32, 64]),
)


def _oracle(params):
    """The scripted metric of a finalized trial: a smooth function of its
    params (and of its budget, where ASHA or Hyperband sets one)."""
    act = {"relu": 0.0, "gelu": 0.1, "silu": 0.2}[params["act"]]
    return (
        -((np.log10(params["lr"]) + 2.0) ** 2)
        + params["width"] / 64.0
        + act
        + params["batch"] / 640.0
        + 0.01 * float(params.get("budget") or 0)
    )


def test_searchspace_samples_and_transforms():
    js, ts = JSpace(**SPACE), TSpace(**SPACE)
    assert ts.to_dict() == js.to_dict() and ts.json() == js.json()
    assert ts.get_random_parameter_values(16, seed=3) == js.get_random_parameter_values(16, seed=3)
    assert [ts.sample(random.Random(5)) for _ in range(4)] == [js.sample(random.Random(5)) for _ in range(4)]
    samples = js.get_random_parameter_values(8, seed=9)
    vec_j, vec_t = js.transform_many(samples), ts.transform_many(samples)
    np.testing.assert_array_equal(vec_t, vec_j)
    for row, params in zip(vec_j, samples):
        assert ts.inverse_transform(row) == js.inverse_transform(row)
        assert ts.inverse_transform(ts.transform(params)) == js.inverse_transform(js.transform(params))
        assert ts.dict_to_list(params) == js.dict_to_list(params)
        assert ts.contains(params) and js.contains(params)


@pytest.mark.parametrize(
    "params",
    [
        {"lr": 0.01, "width": 32, "act": "relu"},
        {"lr": np.float64(0.01), "width": np.int64(32), "act": "relu"},
        {"lr": np.float32(0.1), "width": np.int32(7), "flag": np.bool_(True)},
        {"by_int": {10: "a", 2: "b", np.int64(3): "c"}, "nested": {"a": [1, 2.5, None]}, "arr": np.arange(3)},
        {"budget": 4, "x": 0.25, "grid": np.array([[1.0, 2.0], [3.0, 4.0]])},
    ],
    ids=["native", "numpy-scalars", "numpy-narrow", "keys-nested", "arrays"],
)
def test_trial_ids_identical(params):
    assert TTrial(params).trial_id == JTrial(params).trial_id
    assert TTrial(params).params == JTrial(params).params
    assert TTrial.compute_id(params) == JTrial.compute_id(params)


def test_trial_id_of_a_torch_tensor_matches_its_numpy_value():
    """A torch tensor goes to the host first (numpy takes no CUDA tensor) and
    hashes like the numpy value it holds."""
    as_numpy = {"lr": np.float32(0.1), "w": np.array([1, 2, 3])}
    as_torch = {"lr": torch.tensor(0.1, dtype=torch.float32), "w": torch.tensor([1, 2, 3])}
    assert TTrial(as_torch).trial_id == JTrial(as_numpy).trial_id


def _drive(opt, num_trials, direction, space):
    """A serial driver: each suggestion finalizes at once with the oracle's
    metric. Returns every decision in order."""
    opt.setup(space, num_trials, {}, [], direction=direction)
    decisions = []
    finished = None
    while True:
        suggestion = opt.get_suggestion(finished)
        if suggestion is None or suggestion == "IDLE":
            decisions.append(suggestion)
            return decisions
        opt.trial_store[suggestion.trial_id] = suggestion
        suggestion.begin()
        suggestion.finalize(_oracle(suggestion.params))
        del opt.trial_store[suggestion.trial_id]
        opt.final_store.append(suggestion)
        finished = suggestion
        decisions.append((suggestion.trial_id, suggestion.params, suggestion.info_dict.get("sample_type")))
        assert len(decisions) < 500


@pytest.mark.parametrize(
    "make, num_trials, direction",
    [
        (lambda m: m.RandomSearch(seed=7), 12, "max"),
        (lambda m: m.GridSearch(), None, "max"),
        (lambda m: m.Asha(reduction_factor=2, resource_min=1, resource_max=4, seed=3), 8, "max"),
        (lambda m: m.Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=1), 9, "min"),
        (lambda m: (JTPE if m is j_opt else TTPE)(seed=4, num_warmup_trials=4), 10, "max"),
        (lambda m: (JGP if m is j_opt else TGP)(seed=5, num_warmup_trials=4), 8, "min"),
    ],
    ids=["randomsearch", "gridsearch", "asha-max", "asha-min", "tpe", "gp"],
)
def test_optimizer_decisions_identical(make, num_trials, direction):
    space_j, space_t = JSpace(**SPACE), TSpace(**SPACE)
    if num_trials is None:
        num_trials = j_opt.GridSearch.get_num_trials(space_j)
        assert t_opt.GridSearch.get_num_trials(space_t) == num_trials
    want = _drive(make(j_opt), num_trials, direction, space_j)
    got = _drive(make(t_opt), num_trials, direction, space_t)
    assert len(want) > num_trials // 2
    assert got == want


def test_optimizer_registry_matches():
    for name in ("randomsearch", "gridsearch", "asha", "tpe", "gp", "none"):
        assert type(t_opt.get_optimizer(name, seed=0)).__name__ == type(j_opt.get_optimizer(name, seed=0)).__name__


def _drive_hyperband(mod, direction):
    """Hyperband's pruning routine with each scheduled trial finalized at once
    by a scripted metric; returns every decision in order."""
    finished = {}
    hb = mod.Hyperband(
        lambda ids: {i: finished[i] for i in ids if i in finished},
        eta=3, resource_min=1, resource_max=9, direction=direction,
    )
    decisions = [hb.num_trials()]
    for n in range(200):
        d = hb.pruning_routine()
        decisions.append(d)
        if not isinstance(d, dict):
            return decisions
        tid = f"t{n}"
        hb.report_trial(d["trial_id"], tid)
        # every fifth trial errors (None ranks worst); the rest score by a
        # scripted sequence that is not monotone in the trial's index
        finished[tid] = None if n % 5 == 4 else ((n * 7) % 11) / 11.0 + 0.1 * d["budget"]
    raise AssertionError("hyperband did not finish")


@pytest.mark.parametrize("direction", ["max", "min"])
def test_hyperband_decisions_identical(direction):
    want = _drive_hyperband(j_hb, direction)
    assert want[-1] is None and len(want) > 10
    assert _drive_hyperband(t_hb, direction) == want


def _median_rule_cases(trial_cls):
    def trial(name, metrics, finalize):
        t = trial_cls({"id": name})
        if not finalize:
            t.begin()
        for s, m in enumerate(metrics):
            t.append_metric(m, step=s)
        if finalize:
            t.finalize(metrics[-1])
        return t

    final = [trial(f"f{i}", [0.1 * i, 0.1 * i + 0.05, 0.1 * i + 0.1], True) for i in range(5)]
    running = {
        f"r{i}": trial(f"r{i}", [0.07 * i + 0.01 * s for s in range(1 + i % 3)], False) for i in range(8)
    }
    return running, final


@pytest.mark.parametrize("direction", ["max", "min"])
def test_median_stopping_rule_decisions_identical(direction):
    run_j, fin_j = _median_rule_cases(JTrial)
    run_t, fin_t = _median_rule_cases(TTrial)
    want = j_es.MedianStoppingRule.earlystop_check(run_j, fin_j, direction)
    got = t_es.MedianStoppingRule.earlystop_check(run_t, fin_t, direction)
    assert want and got == want
    assert t_es.NoStoppingRule.earlystop_check(run_t, fin_t, direction) == []
