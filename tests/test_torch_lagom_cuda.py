"""The port's ``lagom()`` on CUDA cards: leases and each executor's current card.

These need a CUDA card (the two-card cases need two): they skip elsewhere. On
the card, run them without the JAX package's test configuration:

    python -m pytest tests/test_torch_lagom_cuda.py -q --noconftest
"""

import threading

import pytest
import torch

from maggy_tpu_torch import Searchspace, experiment
from maggy_tpu_torch.config import HyperparameterOptConfig
from maggy_tpu_torch.core.driver.base import device_groups
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.ops import flash
from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

pytestmark = pytest.mark.cuda

# head_dim 64 in bf16: the flash kernels take it; whole-layer remat, as in llama3_8b
CFG = DecoderConfig.tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=256,
                         remat=True, remat_policy="nothing")


@pytest.fixture()
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()


@pytest.fixture()
def port_env(tmp_path):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    env_mod.set_instance(BaseEnv(str(tmp_path)))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


def _lagom(train_fn, config, timeout=300.0):
    """``experiment.lagom`` on a thread, waited for under a timeout."""
    out = {}

    def run():
        try:
            out["result"] = experiment.lagom(train_fn, config)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), f"lagom did not return within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def test_leases_are_disjoint_cards(cards):
    groups = device_groups(1)
    assert groups == [[torch.device("cuda", i)] for i in range(cards)]
    if cards < 2:
        pytest.skip("one card: two-card leases need two")
    pairs = device_groups(2)
    flat = [d for g in pairs for d in g]
    assert len(pairs) == cards // 2 and len(set(flat)) == len(flat)


def test_each_executor_trains_on_its_lease(cards, port_env):
    """Every executor thread makes its lease current: a model built with
    ``device="cuda"`` inside the trial lands on the trial's own card, and
    concurrent trials hold disjoint cards."""
    if cards < 2:
        pytest.skip("needs two cards")
    n = min(cards, 4)
    seen, lock = [], threading.Lock()
    barrier = threading.Barrier(n, timeout=60)

    def train(hparams, devices):
        barrier.wait()  # every trial is in flight at once
        model = torch.nn.Linear(8, 8, device="cuda")
        with lock:
            seen.append((devices[0], torch.cuda.current_device(), model.weight.device))
        return hparams["x"]

    cfg = HyperparameterOptConfig(
        num_trials=n, optimizer="randomsearch", searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])),
        es_policy="none", hb_interval=0.05, seed=0,
    )
    result = _lagom(train, cfg)
    assert result["num_trials"] == n and result["errors"] == 0
    assert sorted(d.index for d, _, _ in seen) == list(range(n))
    assert all(cur == d.index and wdev == d for d, cur, wdev in seen)


def test_a_trial_trains_the_decoder_through_the_kernels(cards, port_env):
    losses, steps = [], 2

    def train(hparams, reporter, devices):
        trainer = Trainer(Decoder(CFG, device="meta"), adamw(hparams["lr"]), device=devices[0])
        data = synthetic_lm_batches(CFG.vocab_size, 2, 128, seed=0)
        state = trainer.make_state(0, next(data))
        _, metrics = trainer.fit(state, data, steps, reporter=reporter, report_every=1, metrics_window=0)
        losses.append(metrics["loss"])
        return metrics["loss"]

    flash.reset_launches()
    cfg = HyperparameterOptConfig(
        num_trials=1, optimizer="randomsearch", searchspace=Searchspace(lr=("DOUBLE", [1e-4, 1e-3])),
        es_policy="none", hb_interval=0.05, seed=0, direction="min",
    )
    result = _lagom(train, cfg)
    assert result["errors"] == 0 and result["best"]["metric"] == losses[0]
    assert dict(flash.LAUNCHES) == {
        "flash_fwd": 2 * CFG.n_layers * steps,  # forward, and again under remat
        "flash_bwd_dq": CFG.n_layers * steps,
        "flash_bwd_dkv": CFG.n_layers * steps,
    }
