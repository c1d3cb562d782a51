"""``Trainer.fit`` with checkpoints, a preemption save and ``resume="auto"``,
against the port's own uninterrupted run and against the JAX ``fit``.

Both packages start from the same weights (the JAX ``make_state`` init of
``DecoderConfig.tiny()`` in fp32, converted) and read the same synthetic
batches (learnable arithmetic sequences) through their ``batch_iterator``. A reporter broadcasts every step
(``metrics_window=0``) and raises the preemption notice after step 6; the
run checkpoints every 3 steps, so it saves at 3 and 6, returns with
``preempted=1.0``, and a fresh trainer from other weights resumes it.

Tolerances: within the port the resumed trajectory and parameters are
bit-exact (``==``). Against JAX the 12 losses are held to ``rtol=2e-5``, the
tolerance ``tests/test_torch_trainer.py`` holds the same 12-step fp32
trajectory to (Adam divides by the root of the second moment, so last-bit
differences in the gradients grow a little with every step).
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models import Decoder as JDecoder
from maggy_tpu.models import DecoderConfig as JConfig
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu.resilience import preemption as jpreemption
from maggy_tpu.train import TrainContext as JTrainContext
from maggy_tpu.train import data as jdata
from maggy_tpu.train.checkpoint import Checkpointer as JCheckpointer
from maggy_tpu_torch import telemetry
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.resilience import preemption
from maggy_tpu_torch.train import Checkpointer, Trainer, adamw, batch_iterator, synthetic_lm_batches

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
LR = 5e-3
STEPS = 12
PREEMPT_AFTER = 6
EVERY = 3
B, S, ROWS = 4, 32, 64


@pytest.fixture(autouse=True)
def _clear_notices():
    preemption.clear()
    jpreemption.clear()
    yield
    preemption.clear()
    jpreemption.clear()


def _arrays():
    """ROWS learnable arithmetic sequences (the synthetic stream's rows)."""
    return next(synthetic_lm_batches(256, ROWS, S, seed=0))


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX init of tiny() in fp32, and the converted port weights."""
    jcfg = JConfig.tiny(dtype=jnp.float32)
    ctx = JTrainContext.create("dp", devices=jax.devices()[:1])
    jtr = ctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), {"tokens": _arrays()["tokens"][:B]})
    params = decoder_params_from_flax(jax.device_get(unbox(jstate.params)), DecoderConfig.tiny(dtype=torch.float32))
    return jtr, params


class Recorder:
    """A reporter that keeps every broadcast and, after step ``notice``,
    raises the preemption notice through ``request``."""

    def __init__(self, request=None, notice=None):
        self.seen = []
        self.request, self.notice = request, notice

    def broadcast(self, value, step):
        self.seen.append((step, value))
        if self.notice is not None and step == self.notice:
            self.request()


def _port(params, seed=None):
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Decoder(tcfg, device="meta"), adamw(LR), device="cpu")
    sample = {"tokens": _arrays()["tokens"][:B]}
    state = trainer.make_state(0 if seed is None else seed, sample, params=None if seed is not None else params)
    return trainer, state


def _fit_kw(rec, **kw):
    return dict(reporter=rec, report_every=1, metrics_window=0, **kw)


def _port_runs(params, tmp_path):
    # A: uninterrupted
    trainer, state = _port(params)
    rec_a = Recorder()
    state_a, out_a = trainer.fit(state, batch_iterator(_arrays(), B, seed=1), STEPS, **_fit_kw(rec_a))
    # B: checkpoints every 3, preempted after step 6
    ckpt = Checkpointer(str(tmp_path / "port"), max_to_keep=2)
    trainer, state = _port(params)
    rec_b = Recorder(preemption.request, PREEMPT_AFTER)
    tel = telemetry.Telemetry(worker="t")
    with telemetry.current(tel):
        state_b, out_b = trainer.fit(
            state, batch_iterator(_arrays(), B, seed=1), STEPS, checkpointer=ckpt,
            checkpoint_every=EVERY, **_fit_kw(rec_b))
    after_b = ckpt.all_steps()
    preemption.clear()
    # C: other weights, resumed from the checkpoint
    trainer, state = _port(params, seed=123)
    rec_c = Recorder()
    with telemetry.current(tel):
        state_c, out_c = trainer.fit(
            state, batch_iterator(_arrays(), B, seed=1), STEPS, checkpointer=ckpt,
            checkpoint_every=EVERY, resume="auto", **_fit_kw(rec_c))
    ckpt.close()
    return dict(a=(state_a, out_a, rec_a), b=(state_b, out_b, rec_b), c=(state_c, out_c, rec_c),
                after_b=after_b, ckpt=ckpt, counters=tel.snapshot()["counters"],
                gauges=tel.snapshot()["gauges"])


def _jax_runs(jtr, tmp_path):
    def jstate(seed=0):  # the jitted step donates its state: a fresh one per run
        return jtr.make_state(jax.random.key(seed), {"tokens": _arrays()["tokens"][:B]})

    rec_a = Recorder()
    _, out_a = jtr.fit(jstate(), jdata.batch_iterator(_arrays(), B, seed=1), STEPS, **_fit_kw(rec_a))
    ckpt = JCheckpointer(str(tmp_path / "jax"), max_to_keep=2)
    rec_b = Recorder(jpreemption.request, PREEMPT_AFTER)
    state_b, out_b = jtr.fit(
        jstate(), jdata.batch_iterator(_arrays(), B, seed=1), STEPS, checkpointer=ckpt,
        checkpoint_every=EVERY, **_fit_kw(rec_b))
    jpreemption.clear()
    rec_c = Recorder()
    _, out_c = jtr.fit(
        jstate(5), jdata.batch_iterator(_arrays(), B, seed=1), STEPS, checkpointer=ckpt,
        checkpoint_every=EVERY, resume="auto", **_fit_kw(rec_c))
    latest = ckpt.latest_step()
    ckpt.close()
    return dict(a=(out_a, rec_a), b=(out_b, rec_b, int(state_b.step)), c=(out_c, rec_c), latest=latest)


@pytest.fixture(scope="module")
def runs(jax_weights, tmp_path_factory):
    jtr, params = jax_weights
    tmp = tmp_path_factory.mktemp("fit_resume")
    preemption.clear()
    jpreemption.clear()
    try:
        return _port_runs(params, tmp), _jax_runs(jtr, tmp)
    finally:
        preemption.clear()
        jpreemption.clear()


def test_preempted_and_resumed_equals_uninterrupted_bit_for_bit(runs):
    port, _ = runs
    state_a, out_a, rec_a = port["a"]
    state_b, out_b, rec_b = port["b"]
    state_c, out_c, rec_c = port["c"]
    assert out_b["preempted"] == 1.0 and state_b.step == PREEMPT_AFTER
    assert port["after_b"] == [EVERY, PREEMPT_AFTER]
    assert port["ckpt"].all_steps() == [9, 12]  # the resumed run kept its cadence
    assert out_c["resumed_from"] == PREEMPT_AFTER and state_c.step == STEPS
    losses_a = [v for _, v in rec_a.seen]
    assert [v for _, v in rec_b.seen + rec_c.seen] == losses_a
    assert out_c["loss"] == out_a["loss"]
    for (name, p), q in zip(state_a.model.named_parameters(), state_c.model.parameters()):
        assert torch.equal(p, q), name
    assert port["counters"]["resilience.preempt_saves"] == 1
    assert port["counters"]["resilience.auto_resumes"] == 1
    assert port["gauges"]["resumed_step"] == PREEMPT_AFTER


def test_trajectory_equals_jax_fit(runs):
    port, jx = runs
    losses = [v for _, v in port["b"][2].seen + port["c"][2].seen]
    jlosses = [v for _, v in jx["a"][1].seen]
    assert len(losses) == len(jlosses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    assert losses[-1] < losses[0]  # it learns


def test_returned_keys_and_broadcast_steps_equal_jax(runs):
    port, jx = runs
    for run in ("a", "b", "c"):
        assert set(port[run][1]) == set(jx[run][0]), run
        assert [s for s, _ in port[run][2].seen] == [s for s, _ in jx[run][1].seen], run
    assert jx["b"][0]["preempted"] == port["b"][1]["preempted"] == 1.0
    assert jx["c"][0]["resumed_from"] == port["c"][1]["resumed_from"] == PREEMPT_AFTER
    assert jx["b"][2] == port["b"][0].step and jx["latest"] == port["ckpt"].latest_step()


def test_fit_records_jax_gauges(jax_weights):
    _, params = jax_weights
    trainer, state = _port(params)
    tel = telemetry.Telemetry(worker="t")
    with telemetry.current(tel):
        trainer.fit(state, batch_iterator(_arrays(), B, seed=1), 4, **_fit_kw(Recorder()))
    gauges = tel.snapshot()["gauges"]
    for name in ("compile_time_ms", "step_time_ms", "step_time_ms_mean", "steps_per_sec", "tokens_per_sec",
                 "metrics_lag", "metrics_drain_ms", "input_wait_ms", "prefetch_depth"):
        assert name in gauges, name
    assert "mfu_est" not in gauges  # no known peak on the CPU, as in JAX
    events = [e["name"] for e in tel.drain_events() if e["kind"] == "event"]
    assert events.count("train.run_start") == 1 and events.count("train.run_end") == 1


def test_fit_writes_a_profiler_trace(jax_weights, tmp_path):
    _, params = jax_weights
    trainer, state = _port(params)
    trainer.fit(state, batch_iterator(_arrays(), B, seed=1), 4, profile_dir=str(tmp_path / "prof"),
                profile_steps=(1, 2))
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_autopilot_and_membership_raise_naming_their_items(jax_weights):
    _, params = jax_weights
    trainer, state = _port(params)
    with pytest.raises(NotImplementedError, match="item 9"):
        trainer.fit(state, batch_iterator(_arrays(), B, seed=1), 2, autopilot=True)
    # elastic membership is ported: the trainer keeps its monitor, and a
    # pending epoch stops fit at its first step boundary
    from maggy_tpu_torch.resilience.membership import MembershipChanged, MembershipMonitor, MembershipView

    monitor = MembershipMonitor(MembershipView.full(2))
    member = Trainer(Decoder(DecoderConfig.tiny(), device="meta"), adamw(LR), device="cpu", membership=monitor)
    assert member.membership is monitor
    monitor.signal(1)
    trainer.membership = monitor
    with pytest.raises(MembershipChanged, match="epoch 1"):
        trainer.fit(state, batch_iterator(_arrays(), B, seed=1), 2)
    trainer.membership = None
    with pytest.raises(ValueError, match="requires a checkpointer"):
        trainer.fit(state, batch_iterator(_arrays(), B, seed=1), 2, resume="auto")


def test_preemption_hook_sigterm():
    # a hook of its own: the process-wide one may already be installed, and
    # another handler (the JAX package's) may sit on top of it
    prev = signal.getsignal(signal.SIGTERM)
    hook = preemption.PreemptionHook().install()  # pytest runs tests on the main thread
    try:
        assert signal.getsignal(signal.SIGTERM) == hook._handler
        assert not hook.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert hook.wait(timeout=5)
        assert hook.requested()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_preemption_request_from_any_thread():
    t = threading.Thread(target=preemption.request)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert preemption.requested()


CHILD = textwrap.dedent("""
    import sys, time
    import numpy as np, torch
    torch.set_num_threads(2)
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.train import Checkpointer, Trainer, adamw, batch_iterator, synthetic_lm_batches
    directory, steps = sys.argv[1], int(sys.argv[2])
    rng = np.random.default_rng(0)
    arrays = {"tokens": rng.integers(0, 256, (64, 32)).astype(np.int32)}
    trainer = Trainer(Decoder(DecoderConfig.tiny(dtype=torch.float32), device="meta"), adamw(5e-3), device="cpu")
    state = trainer.make_state(0, {"tokens": arrays["tokens"][:4]})

    class Slow:
        def broadcast(self, value, step):
            print(step, flush=True)
            time.sleep(0.05)  # the parent kills it mid-run

    trainer.fit(state, batch_iterator(arrays, 4, seed=1), steps, reporter=Slow(), report_every=1,
                checkpointer=Checkpointer(directory, max_to_keep=2), checkpoint_every=2)
""")


def _committed(directory: Path):
    return sorted(int(p.name) for p in directory.iterdir() if p.name.isdigit() and (p / "state.pt").exists())


def test_sigkill_after_a_committed_save_resumes(tmp_path):
    """A run killed outright (SIGKILL: no handler, no final save) resumes
    from its last committed step and ends where an uninterrupted run ends."""
    steps = 40
    directory = tmp_path / "ck"
    directory.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    child = subprocess.Popen([sys.executable, "-c", CHILD, str(directory), str(steps)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and child.poll() is None and not any(s >= 4 for s in _committed(directory)):
            time.sleep(0.01)
        assert child.poll() is None, child.stderr.read()
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == -signal.SIGKILL
    killed_at = _committed(directory)[-1]
    assert 4 <= killed_at < steps

    rng = np.random.default_rng(0)
    arrays = {"tokens": rng.integers(0, 256, (64, 32)).astype(np.int32)}

    def fresh(seed):
        trainer = Trainer(Decoder(DecoderConfig.tiny(dtype=torch.float32), device="meta"), adamw(5e-3), device="cpu")
        return trainer, trainer.make_state(seed, {"tokens": arrays["tokens"][:4]})

    trainer, ref = fresh(0)
    ref, out_ref = trainer.fit(ref, batch_iterator(arrays, 4, seed=1), steps)
    trainer, state = fresh(99)
    ckpt = Checkpointer(str(directory), max_to_keep=2)
    state, out = trainer.fit(state, batch_iterator(arrays, 4, seed=1), steps, checkpointer=ckpt, resume="auto")
    ckpt.close()
    assert out["resumed_from"] == killed_at and state.step == steps
    assert out["loss"] == out_ref["loss"]
    for (name, p), q in zip(ref.model.named_parameters(), state.model.parameters()):
        assert torch.equal(p, q), name


def test_flops_match_jax(jax_weights):
    """The 6N estimate and parameter count of the port's ``flops`` equal the
    JAX module's, and neither knows a peak for the CPU (no ``mfu_est``)."""
    from maggy_tpu.telemetry import flops as jflops
    from maggy_tpu_torch.telemetry import flops

    jtr, params = jax_weights
    jstate = jtr.make_state(jax.random.key(0), {"tokens": _arrays()["tokens"][:B]})
    trainer, state = _port(params)
    n = flops.param_count(state.model)
    assert n == jflops.param_count(jstate.params) == flops.param_count(params)
    assert flops.flops_per_token(n) == jflops.flops_per_token(n) == 6.0 * n
    assert flops.device_peak_flops("cpu") is None and jflops.device_peak_flops(jax.devices()[0]) is None
    assert flops.estimate_mfu(1e4, n, [torch.device("cpu")]) is None
    assert jflops.estimate_mfu(1e4, n, jax.devices()[:1]) is None



@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),  # the SXM part
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_is_the_h100_sxm_s_only(monkeypatch, name, peak):
    """The peak table holds the H100 SXM by its exact name; the other H100
    parts, slower at bf16, get no peak (and so no ``mfu_est``) rather than
    the SXM's."""
    from maggy_tpu_torch.telemetry import flops

    monkeypatch.setattr(flops.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(flops.torch.cuda, "get_device_name", lambda device=None: name)
    assert flops.device_peak_flops("cuda:0") == peak
    mfu = flops.estimate_mfu(1e4, 10**9, [torch.device("cuda", 0)])
    assert mfu == (None if peak is None else 1e4 * 6e9 / peak)

def test_timeseries_equals_jax():
    """The port's SeriesStore is the JAX module's copy: the same samples give
    the same windows, rates and snapshot."""
    from maggy_tpu.telemetry import timeseries as jts
    from maggy_tpu_torch.telemetry import timeseries as ts

    stores = ts.SeriesStore(), jts.SeriesStore()
    for i in range(20):
        for store in stores:
            store.ingest(100.0 + i, gauges={"step_time_ms": 150.0 + i % 3}, counters={"steps": 2 * i})
    mine, ref = stores
    assert mine.snapshot() == ref.snapshot()
    assert mine.get("steps").rate(10.0, now=119.0) == ref.get("steps").rate(10.0, now=119.0) == 2.0
