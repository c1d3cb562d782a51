"""Restarts in the port: the launcher's generation restart and the
distributed driver's ``max_restarts``, on the CPU with gloo ranks.

* ``python -m maggy_tpu_torch.run --workers 2 --global-mesh --elastic 1``
  (the JAX package's ``test_run_launcher_elastic_restart``): rank 1
  SIGKILLs itself after step 5 of 8, with a checkpoint every 2 steps. The
  launcher logs ``restarting generation 0 -> 1``, generation 1 starts at
  step 4, ``end_step == 8``, and the final parameters equal an
  uninterrupted run's bit for bit.
* ``DistributedConfig(max_restarts=1)``: under ``data_plane="local"`` a
  rank that dies once is relaunched alone and the run completes
  (``resilience.dist_restarts`` 1, the relaunched attempt's outputs in the
  result); a second death past the budget fails the run with every rank
  process reaped; under ``data_plane="auto"`` with 2 ranks, one rank's
  death relaunches both, for one slot.
* The duplicate-death refund: ``_digest_restart`` against the JAX driver's
  counters for the same message sequence, the voided FINAL included.
"""

import glob
import json
import multiprocessing
import os
import pickle
import signal
import time

import numpy as np
import pytest

from test_torch_pod import (  # noqa: F401 - port_env is a fixture
    LR,
    _lagom,
    jax_dp2_reference,
    launch,
    port_env,
    write_data,
)
from maggy_tpu_torch import experiment
from maggy_tpu_torch.config import DistributedConfig

ELASTIC_STEPS, EVERY, KILL_AT = 8, 2, 5


def test_launcher_elastic_generation_restart(tmp_path):
    init, batches, *_ = jax_dp2_reference(ELASTIC_STEPS + 1, 0)
    data = write_data(tmp_path, init, batches)

    def hp(name, kill=None):
        return dict(data=data, lr=LR, steps=ELASTIC_STEPS, ckpt=str(tmp_path / f"{name}_ckpt"), every=EVERY,
                    trace=str(tmp_path / f"{name}_trace"), params_out=str(tmp_path / f"{name}.pkl"), kill=kill)

    _, whole = launch(tmp_path, "whole", hp("whole"))
    proc, cut = launch(tmp_path, "cut", hp("cut", kill=KILL_AT), "--elastic", "1")
    assert "restarting generation 0 -> 1" in proc.stderr, proc.stderr[-2000:]
    # generation 0 started cold, generation 1 resumed from the step-4 checkpoint
    for rank in (0, 1):
        assert (tmp_path / f"cut_trace.g0.r{rank}").read_text() == "0"
        assert (tmp_path / f"cut_trace.g1.r{rank}").read_text() == "4"
    assert cut["num_workers"] == 2 and cut["end_step"] == ELASTIC_STEPS == whole["end_step"]
    with open(tmp_path / "whole.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "cut.pkl", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert cut["loss"] == whole["loss"]


# ------------------------------------------------------------ driver restarts

def _attempt(path: str) -> int:
    """Count this call in ``path`` and return its number (1 first)."""
    n = int(open(path).read()) + 1 if os.path.exists(path) else 1
    with open(path, "w") as f:
        f.write(str(n))
    return n


def dying_train(hparams, ctx):
    """Partition 1 dies (SIGKILL) on each of its first ``hparams["deaths"]``
    attempts; every attempt is counted in ``hparams["dir"]``."""
    part = 0 if ctx.role == "chief" else 1
    n = _attempt(os.path.join(hparams["dir"], f"attempt.{part}"))
    if part == 1 and n <= hparams["deaths"]:
        os.kill(os.getpid(), signal.SIGKILL)
    return {"metric": float(n), "attempt": float(n)}


def collective_train(hparams, ctx):
    """Both ranks all-reduce three times; rank 1 dies after the first on its
    first attempt, so rank 0 loses its peer inside the second."""
    import torch
    import torch.distributed as dist

    n = _attempt(os.path.join(hparams["dir"], f"attempt.{ctx.process_index}"))
    t = torch.ones(4)
    for i in range(3):
        dist.all_reduce(t)
        if ctx.process_index == 1 and n == 1 and i == 0:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(0.2)
    return {"metric": float(t[0]), "attempt": float(n)}


def _counters(exp_dir):
    merged = {}
    for path in glob.glob(os.path.join(exp_dir, "telemetry", "*.jsonl")):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("kind") == "snapshot":
                    for k, v in (rec.get("counters") or {}).items():
                        merged[k] = merged.get(k, 0) + v
    return merged


def _rank_children():
    return [p for p in multiprocessing.active_children() if p.name.startswith("maggy-rank-")]


def test_local_rank_death_is_restarted_alone(port_env, tmp_path):
    result = _lagom(dying_train, DistributedConfig(
        hparams=dict(dir=str(tmp_path), deaths=1), num_executors=2, data_plane="local", max_restarts=1,
        hb_interval=0.05, device="cpu"))
    assert result["num_workers"] == 2
    # partition 1's relaunch reported (its second attempt); partition 0 ran once
    assert result["attempt"] == pytest.approx(1.5)
    assert (tmp_path / "attempt.0").read_text() == "1" and (tmp_path / "attempt.1").read_text() == "2"
    exp_dir = port_env.experiment_dir(experiment.APP_ID, experiment.RUN_ID)
    assert _counters(exp_dir).get("resilience.dist_restarts", 0) == 1
    assert _rank_children() == []


def test_death_past_the_budget_fails_and_reaps(port_env, tmp_path):
    with pytest.raises(Exception, match="rank 1 was lost"):
        _lagom(dying_train, DistributedConfig(
            hparams=dict(dir=str(tmp_path), deaths=5), num_executors=2, data_plane="local", max_restarts=1,
            hb_interval=0.05, device="cpu"))
    assert (tmp_path / "attempt.1").read_text() == "2"  # one restart, then the run failed
    assert _rank_children() == []


def test_a_lost_rank_of_a_group_relaunches_every_rank(port_env, tmp_path):
    result = _lagom(collective_train, DistributedConfig(
        hparams=dict(dir=str(tmp_path)), num_executors=2, sharding="dp", max_restarts=1, hb_interval=0.05,
        device="cpu"))
    assert result["num_workers"] == 2
    assert result["metric"] == 8.0  # three all-reduces over two ranks, in the relaunched group
    # both ranks ran twice: the survivor was torn down and relaunched with its peer
    assert (tmp_path / "attempt.0").read_text() == "2" and (tmp_path / "attempt.1").read_text() == "2"
    exp_dir = port_env.experiment_dir(experiment.APP_ID, experiment.RUN_ID)
    assert _counters(exp_dir).get("resilience.dist_restarts", 0) == 1  # one slot for the whole group
    assert _rank_children() == []


def test_duplicate_death_report_refunds_like_jax(port_env, tmp_env):
    from maggy_tpu.config import DistributedConfig as JDistributedConfig
    from maggy_tpu.core.driver.distributed import DistributedTrainingDriver as JDriver
    from maggy_tpu_torch.core.driver.distributed import DistributedTrainingDriver as TDriver

    kw = dict(hparams={}, sharding="dp", data_plane="local", max_restarts=2, num_executors=2)
    drivers = [JDriver(JDistributedConfig(**kw), "app", 0), TDriver(DistributedConfig(device="cpu", **kw), "app", 0)]
    # a relaunch of partition 0, its duplicate report, then the relaunched
    # partition dying for real; partition 1's FINAL stays, partition 0's
    # earlier FINAL is void
    sequence = [
        {"type": "_RESTART", "partition_id": 0, "error": "x", "restart": 1, "epoch": 0},
        {"type": "_RESTART", "partition_id": 0, "error": "x", "restart": 2, "epoch": 0},
        {"type": "_RESTART", "partition_id": 0, "error": "y", "restart": 2, "epoch": 1},
    ]
    trails = []
    try:
        for d in drivers:
            respawned = []
            d._respawn_executor = respawned.append
            d._finals = [{"partition_id": 0, "metric": 1.0}, {"partition_id": 1, "metric": 2.0}]
            d._final_pids = {0, 1}
            d._restarts = 2  # both deaths already charged on the dying threads
            trail = []
            for msg in sequence:
                d._digest_restart(dict(msg))
                trail.append((d._restarts, d._restart_epoch, dict(d._restarted_at), list(respawned),
                              [m["partition_id"] for m in d._finals], sorted(d._final_pids)))
            trails.append(trail)
    finally:
        for d in drivers:
            d.telemetry.close()
    assert trails[1] == trails[0]
    assert trails[1][0] == (2, 1, {0: 1}, [0], [1], [1])
    assert trails[1][1][0] == 1  # the duplicate's slot refunded
