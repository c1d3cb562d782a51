"""The port's monitor (``maggy_tpu_torch.monitor``) against the JAX
package's: ``render_status`` gives the same text for the same HPO,
distributed, serving-engine and fleet STATUS dicts, and ``main`` attaches
to a live port ``lagom`` driver (``--latest`` through the port's driver
registry, and an explicit ``host:port secret``) and exits 0 when the
driver goes. Every wait has its own timeout."""

import threading
import time

import pytest

from maggy_tpu import monitor as jmonitor
from maggy_tpu_torch import monitor
from maggy_tpu_torch.config import HyperparameterOptConfig
from maggy_tpu_torch.searchspace import Searchspace

HPO = {
    "kind": "HyperparameterOptDriver", "name": "exp", "state": "RUNNING", "app_id": "app_1",
    "run_id": 1, "elapsed_s": 12.5, "direction": "max", "controller": "asha",
    "trials_done": 3, "trials_total": 8, "trials_running": 2, "early_stopped": 1, "errors": 0,
    "best": {"trial_id": "abcd", "metric": 0.91234, "params": {"lr": 0.0031, "opt": "adam"}},
    "controller_log": ["[12:00:00] random trial abcd -> executor 0"],
    "last_seen": {"0": 0.2, "10": 1.5, "2": 0.4},
    "trials_requeued": 2, "quarantined": {"1": 12},
    "telemetry": {
        "0": {"gauges": {"step_time_ms": 174.9, "steps_per_sec": 5.7, "tokens_per_sec": 23456.0,
                         "input_wait_ms": 0.3, "prefetch_depth": 2, "metrics_lag": 1, "mfu_est": 0.41,
                         "compile_time_ms": 2500.0, "heartbeat_rtt_ms": 0.8},
              "counters": {"resilience.worker_deaths": 1, "checkpoint_fallback": 2, "flightrec.dumps": 1}},
        "driver": {"gauges": {"heartbeat_rtt_ms": 1.1}, "counters": {"profcap.captures": 1}},
        "2": {"gauges": {}, "counters": {}},
    },
}

DIST = {
    "kind": "DistributedTrainingDriver", "name": "dist", "state": "RUNNING", "app_id": "a",
    "run_id": 2, "elapsed_s": 3.0, "num_executors": 3, "workers_done": 1, "evaluator_partition": 2,
    "last_seen": {"0": 0.2, "1": 0.1, "2": 5.0}, "membership_epoch": 3, "active_slices": [0, 2],
    "num_slices": 3, "min_slices": 1, "membership_mode": "elastic",
    "telemetry": {"1": {"gauges": {"resilience.active_slices": 2, "resilience.membership_epoch": 3,
                                   "resilience.reshape_ms": 412.0, "train.bucket_count": 4,
                                   "train.comm_exposed_ms": 3.5, "train.comm_overlapped_ms": 9.25}}},
}

SERVE_STATS = {
    "queue_depth": 3, "active_slots": 7, "num_slots": 8, "requests_done": 42, "requests_failed": 1,
    "tokens_out": 12345, "tokens_per_sec": 81.5,
    "paging": {"paged": True, "pages_free": 120, "pages_total": 4097, "pages_shared": 31,
               "heat": {"hot": 300, "warm": 20, "cold": 5}, "fragmentation": {"frag_ratio": 0.125}},
    "preemptions": 2, "memory": {"headroom_pct": 0.31, "unattributed": 123456789},
    "prefix_residency": {"resident_bytes": 5 * 2**20, "resident_prefixes": 3,
                         "top": [{"digest": "ab12", "hits": 7, "bytes": 2**20}]},
    "tier": {"enabled": True, "host_pages_total": 8194, "host_pages_free": 8000, "resident_packs": 4,
             "spills": 9, "fills": 6},
    "profcap": {"captures": 1},
    "ttft_ms_p50": 1257.7, "ttft_ms_p95": 20000.0, "ttft_ms_p99": 23671.0, "tpot_ms_p50": 204.4,
    "slo_attainment": 0.75, "slo_ok": 3, "slo_miss": 1, "compile_counts": {"decode": 1},
    "alerts": [{"alert": "alert.ttft_slo_burn", "severity": "critical"},
               {"alert": "alert.recompile", "program": "decode"}],
}

SERVE = {
    "kind": "serve", "name": "maggy-serve", "state": "serving", "app_id": "maggy-serve", "run_id": 0,
    "elapsed_s": 61.0, "serve": SERVE_STATS,
    "telemetry": {"serve": {"gauges": {"serve.tokens_per_sec": 81.5, "serve.ttft_ms": 1200.0,
                                       "serve.queue_depth": 3, "serve.active_slots": 7,
                                       "serve.drain_ms": 1.5, "serve.decode_retraces": 1,
                                       "serve.pages_free": 120, "serve.pages_shared": 31,
                                       "mem.headroom_pct": 0.31, "serve.pages_hot": 300},
                            "counters": {"serve.prefix_hits": 7, "serve.prefix_tokens_saved": 3584,
                                         "serve.preemptions": 2}}},
}


def fleet_status(autoscale=True, prefilled=True):
    rows = [
        {"replica": 0, "role": "decode", "state": "up", "active_slots": 8, "num_slots": 8, "queue_depth": 2,
         "requests_done": 9, "prefix_hits": 3, "restarts": 0},
        {"replica": 1, "role": "decode", "state": "quarantined", "active_slots": 0, "num_slots": 8,
         "queue_depth": 0, "requests_done": 4, "prefix_hits": 0, "restarts": 1},
        {"replica": 2, "role": "prefill", "state": "draining", "active_slots": 1, "num_slots": 8},
        {"replica": 3, "role": "any", "state": "dead"},
    ]
    routing = {"routed": 16, "requeued": 3, "shed": 1, "respawned": 1,
               "prefilled": 16 if prefilled else 0, "handoffs": 16 if prefilled else 0}
    sv = {
        "queue_depth": 2, "requests_done": 13, "prefix_hits": 3, "prefix_tokens_saved": 1536,
        "pages_total": 8194, "pages_free": 4000, "pages_shared": 12, "preemptions": 1,
        "capacity": {"headroom_pct": 0.2, "pages_hot": 100, "pages_warm": 4, "pages_cold": 1,
                     "fragmentation": 0.05, "resident_bytes": 2**30, "resident_prefixes": 2,
                     "top_prefixes": [{"digest": "ff00", "hits": 8, "bytes": 2**29}],
                     "tier": {"replicas": 2, "host_pages_total": 100, "host_pages_free": 50,
                              "resident_packs": 2, "spills": 3, "fills": 1}},
        "ttft_ms_p50": 900.0, "ttft_ms_p95": 3000.0, "ttft_ms_p99": 5100.0, "tpot_ms_p50": 110.25,
        "alerts": [{"alert": "alert.hbm_headroom", "severity": "critical", "replica": 1}],
        "trends": {"serve.queue_depth": [0, 1, 3, 2, 2], "fleet.healthy_replicas": [2.0, 2.0, 1.0],
                   "serve.tokens_per_sec": [], "serve.ttft_ms": [5.0, 5.0]},
    }
    if autoscale:
        sv["autoscale"] = {"phase": "guard", "min_replicas": 1, "max_replicas": 2, "at_capacity": True,
                           "last_event": {"event": "fleet.scale.up", "reason": "util"}}
    return {"kind": "serve-fleet", "name": "maggy-fleet", "state": "serving", "app_id": "maggy-fleet",
            "run_id": 0, "elapsed_s": 99.9, "serve": sv, "fleet": {"replicas": rows, "routing": routing},
            "telemetry": {"router": {"gauges": {"fleet.healthy_replicas": 1, "serve.handoff_ms": 42.5}}}}


@pytest.mark.parametrize("status", [
    HPO, DIST, SERVE, fleet_status(), fleet_status(autoscale=False, prefilled=False),
    {"name": "bare"}, {**SERVE, "elapsed_s": None},
], ids=["hpo", "distributed", "serve", "fleet", "fleet_plain", "empty", "serve_no_elapsed"])
@pytest.mark.parametrize("width", [78, 120])
def test_render_status_equals_jax(status, width):
    out = monitor.render_status(status, width=width)
    assert out == jmonitor.render_status(status, width=width)
    assert out.splitlines()[0].startswith(status.get("name", "?"))


def test_parse_addr():
    assert monitor._parse_addr("10.0.0.1:7777") == ("10.0.0.1", 7777)
    assert monitor._parse_addr(":80") == ("127.0.0.1", 80)
    with pytest.raises(ValueError, match="host:port"):
        monitor._parse_addr("nohost")


@pytest.fixture()
def port_env(tmp_path):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    env_mod.set_instance(BaseEnv(str(tmp_path / "torch")))
    yield env_mod.get_instance()
    env_mod.set_instance(None)


@pytest.mark.parametrize("attach", ["latest", "addr"])
def test_main_attaches_to_a_live_lagom_driver(port_env, capsys, attach):
    """The port's ``lagom`` runs a study whose trials wait; the monitor
    attaches, prints the driver's progress, and exits 0 once the study ends
    and its driver is gone."""
    from maggy_tpu_torch import experiment

    release = threading.Event()

    def train(hparams, reporter):
        release.wait(timeout=30)
        return hparams["x"]

    cfg = HyperparameterOptConfig(
        num_trials=2, optimizer="randomsearch", searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])),
        direction="max", num_executors=1, hb_interval=0.05, name="monitor-e2e", device="cpu", seed=0,
    )
    holder = {}
    study = threading.Thread(target=lambda: holder.update(r=experiment.lagom(train, cfg)))
    study.start()
    try:
        deadline = time.time() + 30
        while not port_env.list_drivers():
            assert time.time() < deadline, "the driver never registered"
            time.sleep(0.05)
        rec = port_env.list_drivers()[0]
        argv = ["--latest"] if attach == "latest" else [f"127.0.0.1:{rec['port']}", rec["secret"]]
        threading.Timer(1.0, release.set).start()
        rc = []
        mon = threading.Thread(target=lambda: rc.append(monitor.main([*argv, "--interval", "0.05"])))
        mon.start()
        mon.join(timeout=60)
        assert not mon.is_alive(), "the monitor outlived its driver"
    finally:
        release.set()
        study.join(timeout=60)
    assert rc == [0]
    assert holder["r"]["num_trials"] == 2
    out = capsys.readouterr().out
    assert "Starting experiment monitor-e2e" in out and "/2" in out and "driver gone" in out
    if attach == "latest":
        assert f"attaching to 127.0.0.1:{rec['port']}" in out
