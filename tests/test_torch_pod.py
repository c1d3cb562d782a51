"""Pod mode in the port (``maggy_tpu_torch.core.pod``, ``maggy_tpu_torch.run``)
against the JAX package's (``maggy_tpu.core.pod``, ``maggy_tpu.run``), on the
CPU with gloo ranks.

* Role resolution: for each environment, ``worker_role``,
  ``driver_address``, ``partition_id``, ``discover_driver`` (a
  ``scope="local"`` record is ignored) and ``_worker_devices``' eager
  checks give the same outcome in both packages: the role (or None), host
  and port, or the same exception type and message.
* The launcher's argument checks: the same exit code and message as the JAX
  ``main`` for the same bad arguments; and the port's own refusal,
  ``--global-mesh`` with more workers than visible cards, before any spawn.
* Two-process pod training, as the JAX package's ``tests/test_pod.py``:
  the driver in a thread with ``driver_addr`` set (its partition 0 runs in
  this process), the worker a real subprocess with ``MAGGY_TPU_ROLE=worker``.
* ``python -m maggy_tpu_torch.run --workers 2 --global-mesh`` over gloo
  with ``sharding="dp"``: after 3 steps the loss, grad norm and parameters
  equal ``lagom(DistributedConfig(sharding="dp", num_executors=2,
  device="cpu"))`` (spawned ranks) within 1e-6, and the JAX Trainer's under
  dp=2 from the same weights within 2e-5.
* The evaluator: ``DistributedConfig(num_executors=2, data_plane="local",
  evaluator=True, device="cpu")`` gives the last partition
  ``ctx.role == "evaluator"``, its outputs under ``result["evaluator"]`` and
  the training mean from partition 0 only: the JAX ``lagom``'s result for
  the same train_fn, key for key.

Every subprocess and ``lagom`` wait is under its own timeout of 120 s or
less. A test that talks to its driver runs ``lagom`` on a
:class:`DriverThread`, which waits for that run's own driver (never one a
previous test left behind) and is stopped at the test's end whatever its
outcome (``driver_threads``): the driver aborted, its thread joined, its
rank processes reaped.
"""

import inspect
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from maggy_tpu_torch import experiment
from maggy_tpu_torch.config import DistributedConfig

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
LR = 5e-3
STEPS = 3
B, S = 4, 32


@pytest.fixture()
def port_env(tmp_path, monkeypatch):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    root = tmp_path / "torch"
    monkeypatch.setenv("MAGGY_TPU_LOG_ROOT", str(root))
    env_mod.set_instance(BaseEnv(str(root)))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


class DriverThread:
    """``experiment.lagom(train_fn, config)`` on a daemon thread."""

    def __init__(self, train_fn, config):
        self.out = {}
        self.driver = None
        self._previous = experiment.CURRENT_DRIVER
        self.thread = threading.Thread(target=self._run, args=(train_fn, config), daemon=True)
        self.thread.start()

    def _run(self, train_fn, config):
        try:
            self.out["result"] = experiment.lagom(train_fn, config)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            self.out["error"] = e

    def await_driver(self, timeout: float = 60.0):
        """This run's driver once its server listens: a driver that is not
        the one current before the thread started. Raises the run's error
        if it ended first."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            driver = experiment.CURRENT_DRIVER
            if (driver is not None and driver is not self._previous and driver.server is not None
                    and driver.server.port):
                self.driver = driver
                return driver
            if not self.thread.is_alive():
                raise AssertionError(f"lagom ended before its driver listened: {self.out.get('error')!r}")
            time.sleep(0.05)
        raise AssertionError(f"this run's driver did not listen within {timeout} s")

    def join(self, timeout: float = TIMEOUT_S):
        """The run's result (its error raised), once ``lagom`` returned."""
        self.thread.join(timeout)
        assert not self.thread.is_alive(), f"lagom did not return within {timeout} s"
        if "error" in self.out:
            raise self.out["error"]
        return self.out["result"]

    def stop(self) -> None:
        """Abort the run if it still runs (its driver reaps the ranks it
        spawned) and join its thread."""
        if not self.thread.is_alive():
            return
        driver = self.driver or experiment.CURRENT_DRIVER
        if driver is not None:
            driver.abort.set()
            driver.experiment_done.set()
        self.thread.join(60)


@pytest.fixture()
def driver_threads():
    """Start ``DriverThread``s; every one still running at the test's end
    is stopped, so no driver outlives its test."""
    started = []

    def start(train_fn, config):
        started.append(DriverThread(train_fn, config))
        return started[-1]

    yield start
    for run in started:
        run.stop()


def _lagom(train_fn, config):
    run = DriverThread(train_fn, config)
    try:
        return run.join()
    finally:
        run.stop()


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MAGGY_TPU_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    env.update({k: str(v) for k, v in extra.items()})
    return env


# ---------------------------------------------------------------- role parity

_POD_VARS = ("MAGGY_TPU_ROLE", "MAGGY_TPU_DRIVER", "MAGGY_TPU_SECRET", "MAGGY_TPU_PARTITION", "MAGGY_TPU_APP_ID",
             "MAGGY_TPU_RUN_ID", "MAGGY_TPU_WORKER_DEVICES", "MAGGY_TPU_CONNECT_TIMEOUT")

# (environment, config driver_addr, registry record or None)
ROLE_CASES = {
    "explicit_driver": (dict(MAGGY_TPU_ROLE="driver", MAGGY_TPU_DRIVER="10.0.0.1:5000"), None, None),
    "explicit_worker": (dict(MAGGY_TPU_ROLE="worker", MAGGY_TPU_DRIVER="10.0.0.1:5000", MAGGY_TPU_SECRET="s",
                             MAGGY_TPU_PARTITION="3"), None, None),
    "worker_no_address": (dict(MAGGY_TPU_ROLE="worker", MAGGY_TPU_SECRET="s"), None, None),
    "worker_no_secret": (dict(MAGGY_TPU_ROLE="worker", MAGGY_TPU_DRIVER="10.0.0.1:5000"), None, None),
    "config_addr_process_0": ({}, "10.0.0.1:5000", None),
    "registry_address": (dict(MAGGY_TPU_ROLE="worker", MAGGY_TPU_APP_ID="app_pod"), None,
                         dict(host="host-a", port=4242, secret="reg-secret", scope="pod")),
    "registry_local_ignored": (dict(MAGGY_TPU_ROLE="worker", MAGGY_TPU_APP_ID="app_pod",
                                    MAGGY_TPU_CONNECT_TIMEOUT="0.3"), None,
                               dict(host="127.0.0.1", port=4242, secret="reg-secret", scope="local")),
    "bad_host_port": (dict(MAGGY_TPU_ROLE="worker", MAGGY_TPU_DRIVER="10.0.0.1:http", MAGGY_TPU_SECRET="s"),
                      None, None),
    "lease": (dict(MAGGY_TPU_WORKER_DEVICES="0,2"), None, None),
    "lease_duplicate": (dict(MAGGY_TPU_WORKER_DEVICES="1,1"), None, None),
    "lease_negative": (dict(MAGGY_TPU_WORKER_DEVICES="0,-1"), None, None),
    "lease_not_integers": (dict(MAGGY_TPU_WORKER_DEVICES="a,b"), None, None),
}


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the outcome under comparison
        return ("raises", type(e).__name__, str(e))
    if callable(out):
        return ("callable",)
    return ("returns", tuple(out) if isinstance(out, tuple) else out)


def _role_outcomes(pod, env_mod, root, cfg, record):
    from_registry = env_mod.EnvSing.get_instance()
    assert from_registry.root == root
    out = {
        "worker_role": _outcome(lambda: pod.worker_role(cfg)),
        "driver_address": _outcome(lambda: pod.driver_address(cfg)),
        "partition_id": _outcome(pod.partition_id),
        "worker_devices": _outcome(pod._worker_devices),
    }
    if record is not None:
        out["discover_driver"] = _outcome(lambda: (pod.discover_driver("app_pod") or {}).get("port"))
    return out


@pytest.mark.parametrize("case", list(ROLE_CASES))
def test_role_resolution_matches_jax(case, tmp_path, monkeypatch):
    from maggy_tpu.core import env as jenv
    from maggy_tpu.core import pod as jpod
    from maggy_tpu.core.env.base import BaseEnv as JBaseEnv
    from maggy_tpu_torch.core import env as tenv
    from maggy_tpu_torch.core import pod as tpod
    from maggy_tpu_torch.core.env.base import BaseEnv as TBaseEnv

    env, addr, record = ROLE_CASES[case]
    for var in _POD_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    root = str(tmp_path)
    jenv.set_instance(JBaseEnv(root))
    tenv.set_instance(TBaseEnv(root))
    try:
        if record is not None:
            rec = dict(record)
            jenv.EnvSing.get_instance().register_driver("app_pod", 1, rec.pop("host"), rec.pop("port"), **rec)
        cfg = types.SimpleNamespace(driver_addr=addr)
        want = _role_outcomes(jpod, jenv, root, cfg, record)
        got = _role_outcomes(tpod, tenv, root, cfg, record)
    finally:
        jenv.set_instance(None)
        tenv.set_instance(None)
    assert got == want
    for part in ("ab", "10.0.0.1:", ":5000", "h:5000"):
        assert _outcome(lambda: tpod._parse_addr(part)) == _outcome(lambda: jpod._parse_addr(part))


def test_worker_devices_resolve_to_the_cpu_or_raise_without_cuda(monkeypatch):
    from maggy_tpu_torch.core import pod as tpod

    monkeypatch.setenv("MAGGY_TPU_WORKER_DEVICES", "0")
    lease = tpod._worker_devices(types.SimpleNamespace(device="cpu"))
    assert lease() == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpod._worker_devices(types.SimpleNamespace(device=None))()


# ----------------------------------------------------------- launcher parity

ARG_CASES = {
    "workers_zero": ["--workers", "0", "nope.py"],
    "workers_negative": ["--workers", "-3", "nope.py"],
    "workers_not_int": ["--workers", "two", "nope.py"],
    "elastic_negative": ["--elastic", "-1", "nope.py"],
    "respawn_negative": ["--respawn", "-1", "{ok}"],
    "no_script": [],
    "unknown_flag": ["--bogus", "nope.py"],
}


def _main_outcome(main, argv, capfd):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    err = capfd.readouterr().err
    return code, [line for line in err.splitlines() if line.startswith("usage:") or "error:" in line]


@pytest.mark.parametrize("case", list(ARG_CASES))
def test_launcher_arguments_match_jax(case, tmp_path, monkeypatch, capfd):
    from maggy_tpu import run as jrun
    from maggy_tpu_torch import run as trun

    ok = tmp_path / "ok.py"
    ok.write_text("print('ran')\n")
    argv = [a.format(ok=ok) for a in ARG_CASES[case]]
    monkeypatch.chdir(tmp_path)
    want = _main_outcome(jrun.main, argv, capfd)
    got = _main_outcome(trun.main, argv, capfd)
    assert got == want
    assert (got[0] == 0) == (case == "respawn_negative")


def test_global_mesh_with_too_few_cards_refuses_before_any_spawn(monkeypatch, capfd):
    from maggy_tpu_torch import run as trun

    def no_spawn(*a, **k):
        raise AssertionError("the launcher started a process")

    monkeypatch.setattr(trun, "_visible_cards", lambda: 2)
    monkeypatch.setattr(trun.subprocess, "Popen", no_spawn)
    with pytest.raises(SystemExit) as e:
        trun.main(["--workers", "3", "--global-mesh", "script.py"])
    assert e.value.code == 2
    assert "3 workers need 3 CUDA cards, 2 visible" in capfd.readouterr().err
    monkeypatch.setattr(trun, "_visible_cards", lambda: None)  # no CUDA: the ranks are the CPU's
    monkeypatch.setattr(trun, "_spawn_generation", no_spawn)
    with pytest.raises(AssertionError, match="started a process"):
        trun.main(["--workers", "3", "--global-mesh", "script.py"])


# ----------------------------------------------------------- pod training

WORKER_SCRIPT = textwrap.dedent(
    """
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.config import DistributedConfig

    def train(hparams, reporter, ctx):
        reporter.broadcast(1.0, step=0)
        return {"metric": float(hparams["base"]) + 1.0, "role": 1.0 if ctx.role == "worker" else 0.0}

    result = experiment.lagom(train, DistributedConfig(
        hparams={"base": 10.0}, num_executors=2, sharding="dp", data_plane="local",
        hb_interval=0.05, device="cpu"))
    print("WORKER-DONE", result)
    """
)


def pod_metric_train(hparams, reporter, ctx):
    reporter.broadcast(1.0, step=0)
    return {"metric": float(hparams["base"]) + 1.0, "role": 1.0 if ctx.role == "worker" else 0.0}


def test_pod_two_process_training(port_env, tmp_path, driver_threads):
    config = DistributedConfig(hparams={"base": 10.0}, num_executors=2, sharding="dp", data_plane="local",
                               driver_addr="127.0.0.1:auto", hb_interval=0.05, device="cpu")
    run = driver_threads(pod_metric_train, config)
    driver = run.await_driver()
    assert driver.pod_mode
    # the pod driver's registry record is cross-host: scope "pod", its host name
    rec = port_env.lookup_driver(driver.app_id)
    assert rec["scope"] == "pod" and rec["port"] == driver.server.port
    script = tmp_path / "worker.py"
    script.write_text(WORKER_SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, timeout=TIMEOUT_S,
        env=_child_env(MAGGY_TPU_ROLE="worker", MAGGY_TPU_DRIVER=f"127.0.0.1:{driver.server.port}",
                       MAGGY_TPU_SECRET=driver.server.secret, MAGGY_TPU_PARTITION=1,
                       MAGGY_TPU_LOG_ROOT=tmp_path / "worker_logs"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "WORKER-DONE" in proc.stdout and "'role': 'worker'" in proc.stdout
    result = run.join(60)
    assert result["num_workers"] == 2
    assert result["metric"] == pytest.approx(11.0)  # both workers returned 11.0, as in JAX
    assert result["role"] == pytest.approx(0.5)  # partition 0 the chief, partition 1 a worker
    assert experiment.CURRENT_DRIVER is None


def pod_train(hparams, reporter, ctx):
    """The launcher's and lagom's train_fn: the tiny fp32 Decoder from the
    given weights, ``hparams["steps"]`` fit steps over the given batches;
    rank 0 saves the final parameters. With ``hparams["ckpt"]`` it
    checkpoints every ``hparams["every"]`` steps and resumes from the
    latest; rank 1 of generation 0 kills itself after step
    ``hparams["kill"]``."""
    import functools
    import os
    import pickle
    import signal

    import torch

    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.train import Checkpointer, adamw

    with open(hparams["data"], "rb") as f:
        data = pickle.load(f)
    batches = data["batches"]
    init = {k: torch.from_numpy(v) for k, v in data["init"].items()}
    optimizer = functools.partial(adamw(hparams["lr"]), foreach=True)  # as on a card
    trainer = ctx.trainer(Decoder(DecoderConfig.tiny(dtype=torch.float32), device="meta"), optimizer)
    state = trainer.make_state(0, batches[0], params=init)
    steps = hparams["steps"]
    stream = iter([batches[1 + i % (len(batches) - 1)] for i in range(steps)])
    gen = int(os.environ.get("MAGGY_TPU_GENERATION", "0"))
    kw, ckpt = {}, None
    if hparams.get("ckpt"):
        ckpt = Checkpointer(hparams["ckpt"], async_save=False)
        start = ckpt.latest_step()
        with open(f"{hparams['trace']}.g{gen}.r{ctx.process_index}", "w") as f:
            f.write(str(start or 0))
        kw = dict(checkpointer=ckpt, checkpoint_every=hparams["every"], resume="auto")
    grad_norms = []

    class Kill:
        def broadcast(self, value, step):
            if gen == 0 and ctx.process_index == 1 and step == hparams.get("kill"):
                os.kill(os.getpid(), signal.SIGKILL)

    state, m = trainer.fit(state, stream, steps, reporter=Kill(), report_every=1, metrics_window=0, **kw)
    grad_norms.append(m["grad_norm"])
    if ckpt is not None:
        ckpt.close()
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().numpy().copy()
              for n, p in state.model.named_parameters()}
    if ctx.process_index == 0:
        with open(hparams["params_out"], "wb") as f:
            pickle.dump(params, f)
    return {"metric": m["loss"], "loss": m["loss"], "grad_norm": m["grad_norm"], "end_step": state.step,
            "world": ctx.num_processes, "rank": ctx.process_index}


LAUNCHED_SCRIPT = """
import json, os, sys
import torch
import maggy_tpu_torch

assert maggy_tpu_torch.initialize_data_plane(device="cpu"), "the launcher exports MAGGY_TPU_COORDINATOR"
torch.set_num_threads(1)

from maggy_tpu_torch import experiment
from maggy_tpu_torch.config import DistributedConfig

{train_src}

hparams = json.loads(os.environ["MT_HPARAMS"])
result = experiment.lagom(pod_train, DistributedConfig(
    hparams=hparams, sharding="dp", data_plane="auto", hb_interval=0.05, device="cpu"))
if result.get("role") is None:
    with open(os.environ["MT_RESULT_FILE"], "w") as f:
        json.dump(result, f)
print("LAUNCHED_OK", flush=True)
"""


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


def jax_dp2_reference(n_batches: int, steps: int):
    """The JAX Trainer under dp=2: its initial weights (as the port's state
    dict), the batches, and after ``steps`` steps its loss, grad norm and
    weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from maggy_tpu.models import Decoder as JDecoder
    from maggy_tpu.models import DecoderConfig as JConfig
    from maggy_tpu.parallel.sharding import unbox
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.train import TrainContext as JTrainContext
    from maggy_tpu_torch.convert import decoder_params_from_flax
    from maggy_tpu_torch.models import DecoderConfig

    jctx = JTrainContext.create(JShardingSpec(dp=2), devices=jax.devices()[:2])
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    batches = packed_batches(jcfg.vocab_size, n_batches)
    jtr = jctx.trainer(JDecoder(jcfg), optax.adamw(LR))
    jstate = jtr.make_state(jax.random.key(0), batches[0])

    def torch_params(state):
        return {k: v.numpy() for k, v in decoder_params_from_flax(jax.device_get(unbox(state.params)), tcfg).items()}

    init = torch_params(jstate)
    jm = {"loss": float("nan"), "grad_norm": float("nan")}
    for i in range(steps):
        jstate, jm = jtr.step(jstate, jtr.shard_batch(batches[1 + i % (n_batches - 1)]))
    return init, batches, float(jm["loss"]), float(jm["grad_norm"]), torch_params(jstate)


def launch(tmp_path, name, hparams, *flags, timeout=TIMEOUT_S):
    """``python -m maggy_tpu_torch.run --workers 2 --global-mesh [flags]``
    on the pod script; returns the process and the driver's result."""
    import json

    script = tmp_path / f"{name}.py"
    script.write_text(LAUNCHED_SCRIPT.replace("{train_src}", inspect.getsource(pod_train)))
    result_file = tmp_path / f"{name}.json"
    proc = subprocess.run(
        [sys.executable, "-m", "maggy_tpu_torch.run", "--workers", "2", "--global-mesh", *flags, str(script)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=_child_env(MAGGY_TPU_LOG_ROOT=tmp_path / f"{name}_logs", MT_RESULT_FILE=result_file,
                       MT_HPARAMS=json.dumps(hparams), MAGGY_TPU_CONNECT_TIMEOUT=60),
    )
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-3000:])
    assert proc.stdout.count("LAUNCHED_OK") == 2
    return proc, json.loads(result_file.read_text())


def write_data(tmp_path, init, batches) -> str:
    path = tmp_path / "data.pkl"
    with open(path, "wb") as f:
        pickle.dump({"init": init, "batches": batches}, f)
    return str(path)


def test_launcher_global_mesh_matches_lagom_and_jax(port_env, tmp_path):
    init, batches, jloss, jnorm, jparams = jax_dp2_reference(STEPS + 1, STEPS)
    data = write_data(tmp_path, init, batches)
    hp = dict(data=data, lr=LR, steps=STEPS)
    _, launched = launch(tmp_path, "dp2", dict(hp, params_out=str(tmp_path / "launched.pkl")))
    spawned = _lagom(pod_train, DistributedConfig(
        hparams=dict(hp, params_out=str(tmp_path / "spawned.pkl")), sharding="dp", num_executors=2,
        hb_interval=0.05, device="cpu"))
    with open(tmp_path / "launched.pkl", "rb") as f:
        lp = pickle.load(f)
    with open(tmp_path / "spawned.pkl", "rb") as f:
        sp = pickle.load(f)
    assert launched["num_workers"] == 2 and launched["world"] == 2 and launched["end_step"] == STEPS
    assert launched["rank"] == 0.5  # both ranks reported, averaged
    assert launched["loss"] == pytest.approx(spawned["loss"], rel=1e-6, abs=0)
    assert launched["grad_norm"] == pytest.approx(spawned["grad_norm"], rel=1e-6, abs=0)
    assert launched["loss"] == pytest.approx(jloss, rel=2e-5)
    assert launched["grad_norm"] == pytest.approx(jnorm, rel=2e-5)
    assert sorted(lp) == sorted(sp) == sorted(jparams)
    for name in jparams:
        np.testing.assert_allclose(lp[name], sp[name], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(lp[name], jparams[name], rtol=0, atol=2e-5, err_msg=name)


# ------------------------------------------------------------------ evaluator

def evaluator_train(ctx, reporter):
    if ctx.role == "evaluator":
        return {"eval_loss": 0.5, "note": "checkpoint-500 looks best"}
    return {"metric": 1.0, "train_loss": 2.0}


def test_evaluator_matches_jax(port_env, tmp_env):
    from maggy_tpu import experiment as jexperiment
    from maggy_tpu.config import DistributedConfig as JDistributedConfig

    kw = dict(num_executors=2, sharding="dp", data_plane="local", evaluator=True, hb_interval=0.05)
    want = jexperiment.lagom(evaluator_train, JDistributedConfig(**kw))
    got = _lagom(evaluator_train, DistributedConfig(device="cpu", **kw))
    assert got == want
    assert got["num_workers"] == 1 and got["metric"] == 1.0  # the training mean: partition 0 alone
    assert got["evaluator"] == {"eval_loss": 0.5, "note": "checkpoint-500 looks best"}
    roles = {p.parent.name: __import__("json").loads(p.read_text())
             for p in Path(port_env.root).rglob(".outputs.json")}
    assert roles["worker_1"]["eval_loss"] == 0.5 and roles["worker_0"]["train_loss"] == 2.0
    with pytest.raises(ValueError, match="num_executors >= 2"):
        _lagom(evaluator_train, DistributedConfig(num_executors=1, evaluator=True, data_plane="local",
                                                  device="cpu"))
    with pytest.raises(ValueError, match="requires data_plane='local'"):
        _lagom(evaluator_train, DistributedConfig(num_executors=2, evaluator=True, device="cpu"))
