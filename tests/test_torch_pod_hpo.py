"""Pod-mode HPO, ablation and liveness in the port, on the CPU: the JAX
package's ``tests/test_pod_hpo.py`` and ``tests/test_pod_liveness.py``
with tiny trials.

* A remote trial worker SIGKILLed mid-study and respawned (what
  ``maggy_tpu_torch.run --respawn`` does) re-registers, its lost trial is
  freed, and the study ends with the full trial count.
* With no respawn, the liveness sweep (``worker_timeout``) frees the dead
  worker's trial and the driver's own executor finishes the budget.
* ``MAGGY_TPU_WORKER_DEVICES`` leases the worker its devices, resolved
  after it registered (the CPU under ``device="cpu"``).
* A distributed pod worker that registers and goes silent aborts the run
  with "silent", instead of hanging the driver.
* An ablation pod worker rebuilds the LOCO resolver from its own
  ``AblationConfig`` and runs a trial on its variant.
* ``python -m maggy_tpu_torch.run --workers 2 --respawn 1``: a worker rank
  that dies is respawned into the live study, which completes.

Every subprocess and ``lagom`` wait is under its own timeout of 120 s or
less.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from test_torch_pod import REPO, TIMEOUT_S, _child_env, port_env  # noqa: F401 - port_env is a fixture
from maggy_tpu_torch import Searchspace, experiment
from maggy_tpu_torch.config import DistributedConfig, HyperparameterOptConfig

HPO_WORKER_SCRIPT = textwrap.dedent(
    """
    import os, time
    from maggy_tpu_torch import Searchspace, experiment
    from maggy_tpu_torch.config import HyperparameterOptConfig

    SERVED = []

    def train(hparams, reporter, devices):
        if not SERVED:
            open(os.environ["MT_MARKER"], "a").close()  # this worker holds a trial
        SERVED.append(devices)
        reporter.broadcast(float(hparams["x"]), step=0)
        time.sleep({trial_s})
        return {{"metric": float(hparams["x"])}}

    result = experiment.lagom(train, HyperparameterOptConfig(
        num_trials=10, optimizer="randomsearch", searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])),
        direction="max", es_policy="none", num_executors=2, hb_interval=0.05, device="cpu"))
    print("WORKER-DONE", result, "served", len(SERVED), "lease", SERVED[0] if SERVED else None, flush=True)
    """
)


def _start_driver(holder, worker_timeout=600.0, trial_s=0.3, num_trials=30):
    def train(hparams, reporter):
        reporter.broadcast(float(hparams["x"]), step=0)
        time.sleep(trial_s)
        return {"metric": float(hparams["x"])}

    config = HyperparameterOptConfig(
        num_trials=num_trials, optimizer="randomsearch", searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])),
        direction="max", es_policy="none", num_executors=2, hb_interval=0.05,
        driver_addr="127.0.0.1:auto",  # placeholder: flags pod mode
        worker_timeout=worker_timeout, device="cpu")

    def run_driver():
        try:
            holder["result"] = experiment.lagom(train, config)
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            holder["error"] = e

    t = threading.Thread(target=run_driver, daemon=True)
    t.start()
    return t, _await_driver()


def _await_driver():
    deadline = time.time() + 30
    driver = None
    while time.time() < deadline:
        driver = experiment.CURRENT_DRIVER
        if driver is not None and driver.server is not None and driver.server.port:
            break
        time.sleep(0.05)
    assert driver is not None and driver.server is not None, "driver never started"
    assert driver.pod_mode
    return driver


def _worker_env(driver, tmp_path, **extra):
    return _child_env(MAGGY_TPU_ROLE="worker", MAGGY_TPU_DRIVER=f"127.0.0.1:{driver.server.port}",
                      MAGGY_TPU_SECRET=driver.server.secret, MAGGY_TPU_PARTITION=1,
                      MAGGY_TPU_LOG_ROOT=tmp_path / "worker_logs", MT_MARKER=tmp_path / "marker", **extra)


def _spawn(script, env):
    return subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _await_marker(tmp_path, proc):
    deadline = time.time() + 60
    while not (tmp_path / "marker").exists():
        assert proc.poll() is None, proc.stdout.read()[-2000:]
        assert time.time() < deadline, "the worker never held a trial"
        time.sleep(0.05)


def _kill(proc):
    proc.kill()
    proc.communicate(timeout=30)


def test_pod_hpo_worker_kill_and_respawn_completes_all_trials(port_env, tmp_path):
    holder = {}
    t, driver = _start_driver(holder, trial_s=0.4, num_trials=40)
    script = tmp_path / "worker.py"
    script.write_text(HPO_WORKER_SCRIPT.format(trial_s=0.4))
    victim = _spawn(script, _worker_env(driver, tmp_path))
    _await_marker(tmp_path, victim)  # the victim dies holding a trial
    _kill(victim)
    replacement = _spawn(script, _worker_env(driver, tmp_path))
    out, _ = replacement.communicate(timeout=TIMEOUT_S)
    assert replacement.returncode == 0, out[-2000:]
    assert "'role': 'trial_worker'" in out
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive(), "driver did not finish"
    assert "error" not in holder, holder.get("error")
    result = holder["result"]
    # the full count despite the kill; the lost trial was requeued, not failed
    assert result["num_trials"] == 40
    assert result.get("errors", 0) == 0
    assert result["best"] is not None


def test_pod_hpo_dead_worker_liveness_frees_trial_and_completes(port_env, tmp_path):
    holder = {}
    t, driver = _start_driver(holder, worker_timeout=2.0, trial_s=0.3, num_trials=20)
    script = tmp_path / "worker.py"
    script.write_text(HPO_WORKER_SCRIPT.format(trial_s=0.3))
    victim = _spawn(script, _worker_env(driver, tmp_path))
    _await_marker(tmp_path, victim)
    _kill(victim)
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive(), "driver hung after worker death"
    assert "error" not in holder, holder.get("error")
    result = holder["result"]
    assert result["num_trials"] == 20
    assert result.get("errors", 0) == 0


def test_pod_worker_device_lease(port_env, tmp_path):
    holder = {}
    t, driver = _start_driver(holder, trial_s=0.4, num_trials=30)
    script = tmp_path / "worker.py"
    script.write_text(HPO_WORKER_SCRIPT.format(trial_s=0.1))
    bad_env = _worker_env(driver, tmp_path, MAGGY_TPU_WORKER_DEVICES="1,1")
    worker = _spawn(script, _worker_env(driver, tmp_path, MAGGY_TPU_WORKER_DEVICES="1,2"))
    out, _ = worker.communicate(timeout=TIMEOUT_S)
    assert worker.returncode == 0, out[-2000:]
    served = int(out.split(" served ")[1].split()[0])
    assert served > 0, out[-1500:]
    assert "lease [device(type='cpu')]" in out  # the lease, resolved once registered
    t.join(timeout=TIMEOUT_S)
    assert "error" not in holder, holder.get("error")
    assert holder["result"]["num_trials"] == 30
    bad = _spawn(script, bad_env)
    out, _ = bad.communicate(timeout=TIMEOUT_S)
    assert bad.returncode != 0 and "must name distinct" in out  # checked before it registers


def silent_train(hparams, reporter, ctx):
    reporter.broadcast(1.0, step=0)
    return {"metric": 1.0}


def test_silent_pod_worker_aborts(port_env):
    from maggy_tpu_torch.core import rpc

    config = DistributedConfig(hparams={}, num_executors=2, sharding="dp", data_plane="local",
                               driver_addr="127.0.0.1:1",  # pod mode marker (the driver never dials it)
                               worker_timeout=2.0, hb_interval=0.05, device="cpu")
    holder = {}

    def run():
        try:
            experiment.lagom(silent_train, config)
        except BaseException as e:  # noqa: BLE001
            holder["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    driver = _await_driver()
    # impersonate remote partition 1: register once, then go silent
    ghost = rpc.Client(("127.0.0.1", driver.server.port), 1, driver.server.secret, hb_interval=0.05)
    ghost.register({"host": "preempted-host"})
    ghost.stop()
    t.join(timeout=60)
    assert not t.is_alive(), "driver hung on the silent worker"
    assert "silent" in str(holder.get("error"))


ABLATION_SCRIPT = """
import os, time
import torch
from maggy_tpu_torch import experiment
from maggy_tpu_torch.ablation import AblationStudy
from maggy_tpu_torch.config import AblationConfig
from maggy_tpu_torch.models import Decoder, DecoderConfig


def ablation_train(model, reporter, devices, ablated_component):
    if os.environ.get("MAGGY_TPU_ROLE") == "worker":
        print("SERVED", ablated_component, sorted(model.cfg.ablated), flush=True)
        open(os.environ["MT_MARKER"], "a").close()
    elif not os.path.exists(os.environ["MT_MARKER"]):
        # the driver's executor holds its first trial until the worker has run one
        deadline = time.time() + 60
        while not os.path.exists(os.environ["MT_MARKER"]) and time.time() < deadline:
            time.sleep(0.05)
    n = float(sum(p.numel() for p in model.parameters()))
    reporter.broadcast(n, step=0)
    return n


def study():
    s = AblationStudy()
    s.model.layers.include("mlp", "layers.0")
    return s


def config(**kw):
    return AblationConfig(ablation_study=study(), model=Decoder(DecoderConfig.tiny(dtype=torch.float32),
                          device="meta"), direction="max", hb_interval=0.05, device="cpu", **kw)


if __name__ == "__main__":
    print("WORKER-DONE", experiment.lagom(ablation_train, config()), flush=True)
"""


def test_pod_ablation_worker_rebuilds_the_resolver(port_env, tmp_path, monkeypatch):
    import importlib.util

    path = tmp_path / "ablation_script.py"
    path.write_text(ABLATION_SCRIPT)
    spec = importlib.util.spec_from_file_location("ablation_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv("MT_MARKER", str(tmp_path / "marker"))
    holder = {}

    def run_driver():
        try:
            holder["result"] = experiment.lagom(mod.ablation_train, mod.config(driver_addr="127.0.0.1:auto"))
        except BaseException as e:  # noqa: BLE001
            holder["error"] = e

    t = threading.Thread(target=run_driver, daemon=True)
    t.start()
    driver = _await_driver()
    proc = subprocess.run([sys.executable, str(path)], env=_worker_env(driver, tmp_path), capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    served = [line.split(" ", 2)[1:] for line in proc.stdout.splitlines() if line.startswith("SERVED")]
    assert served, proc.stdout[-2000:]
    for component, ablated in served:
        # the worker's own resolver built the trial's variant
        want = [] if component == "None" else [component]
        assert ablated == str(want), (component, ablated)
    t.join(timeout=TIMEOUT_S)
    assert "error" not in holder, holder.get("error")
    assert holder["result"]["num_trials"] == 3


RESPAWN_SCRIPT = """
import os, sys, time
sentinel = {sentinel!r}
if os.environ.get("MAGGY_TPU_ROLE") == "worker" and not os.path.exists(sentinel):
    open(sentinel, "w").close()
    sys.exit(3)  # a crash before joining
from maggy_tpu_torch import Searchspace, experiment
from maggy_tpu_torch.config import HyperparameterOptConfig


def train(hparams, reporter):
    reporter.broadcast(float(hparams["x"]), step=0)
    time.sleep(0.1)
    return {{"metric": float(hparams["x"])}}


result = experiment.lagom(train, HyperparameterOptConfig(
    num_trials=40, optimizer="randomsearch", searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])),
    direction="max", es_policy="none", num_executors=2, hb_interval=0.05, device="cpu"))
print("RESULT", result, flush=True)
"""


def test_run_launcher_respawn_recovers_worker(tmp_path):
    sentinel = str(tmp_path / "crashed_once")
    script = tmp_path / "user_script.py"
    script.write_text(RESPAWN_SCRIPT.format(sentinel=sentinel))
    proc = subprocess.run(
        [sys.executable, "-m", "maggy_tpu_torch.run", "--workers", "2", "--respawn", "2", str(script)],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S,
        env=_child_env(MAGGY_TPU_LOG_ROOT=tmp_path / "logs", MAGGY_TPU_CONNECT_TIMEOUT=30),
    )
    assert os.path.exists(sentinel), "the worker never took the crash path"
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith("RESULT")]
    assert any("'num_trials': 40" in line for line in lines), lines
    assert any("'role': 'trial_worker'" in line for line in lines), lines
    assert "respawning into the live experiment" in proc.stderr
