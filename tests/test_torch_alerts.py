"""The port's alert rules, recompile sentinel and alert-triggered profile
capture: the cases of ``tests/test_timeseries.py`` and
``tests/test_capacity.py`` that the serving scheduler relies on, run against
both packages on the same scripted series; then the scheduler's sentinel on
the port's engine (a decode shape added outside the reconfigure seam trips
it) and the capture's mode on the CPU."""

import json
import os
import time
import types

import pytest
import torch

from maggy_tpu.telemetry import alerts as jalerts
from maggy_tpu.telemetry import flightrec as jflightrec
from maggy_tpu.telemetry import memtrack as jmemtrack
from maggy_tpu.telemetry import profcap as jprofcap
from maggy_tpu.telemetry import recorder as jrecorder
from maggy_tpu.telemetry import timeseries as jtimeseries
from maggy_tpu_torch.telemetry import alerts, flightrec, memtrack, profcap, recorder, timeseries

PACKAGES = {
    "jax": types.SimpleNamespace(alerts=jalerts, flightrec=jflightrec, memtrack=jmemtrack, profcap=jprofcap,
                                 recorder=jrecorder, timeseries=jtimeseries),
    "torch": types.SimpleNamespace(alerts=alerts, flightrec=flightrec, memtrack=memtrack, profcap=profcap,
                                   recorder=recorder, timeseries=timeseries),
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class _EventTap:
    """Minimal recorder stand-in capturing alert transition events."""

    def __init__(self):
        self.events = []

    def event(self, name, trace=None, **attrs):
        self.events.append((name, attrs))

    def gauge(self, *a, **k):
        pass

    def count(self, *a, **k):
        pass

    def names(self, kind):
        return [n for n, _ in self.events if n == kind]


def test_threshold_rule_for_duration_and_transitions(pkg):
    a = pkg.alerts
    tap = _EventTap()
    store = pkg.timeseries.SeriesStore()
    ev = a.AlertEvaluator(store, tap, scope="worker", rules=(a.BY_NAME["alert.queue_depth_high"],))
    t0 = 5000.0
    s = store.series("serve.queue_depth", "gauge")
    for i in range(3):  # over threshold but shorter than for_s=3
        s.append(t0 + i, 100.0)
        ev.evaluate(t0 + i)
    assert ev.firing() == []
    s.append(t0 + 3, 100.0)
    assert [t["alert"] for t in ev.evaluate(t0 + 3)] == ["alert.queue_depth_high"]
    assert ev.firing()[0]["severity"] == "warning" and tap.names(a.ALERT_FIRING)
    s.append(t0 + 4, 1.0)  # a one-tick dip resolves
    resolved = ev.evaluate(t0 + 4)
    assert resolved and resolved[0]["event"] == a.ALERT_RESOLVED
    assert ev.firing() == [] and tap.names(a.ALERT_RESOLVED)
    ev2 = a.AlertEvaluator(store, None, scope="worker", rules=(a.BY_NAME["alert.queue_depth_high"],))
    s.append(t0 + 5, 100.0)
    for dt in (5, 6, 7, 8):  # a stale series never fires
        ev2.evaluate(t0 + 100 + dt)
    assert ev2.firing() == []


def test_burn_rate_multiwindow_fire_and_resolve(pkg):
    a = pkg.alerts
    tap = _EventTap()
    store = pkg.timeseries.SeriesStore()
    ev = a.AlertEvaluator(store, tap, scope="worker", rules=(a.BY_NAME["alert.ttft_slo_burn"],))
    t0, ok, miss, tick = 6000.0, 0, 0, 0
    trace = []
    for phase, (d_ok, d_miss, n) in enumerate(((10, 0, 35), (6, 4, 6), (10, 0, 12))):
        for _ in range(n):
            ok, miss = ok + d_ok, miss + d_miss
            store.ingest(t0 + tick, counters={"serve.slo_ok": ok, "serve.slo_miss": miss})
            trace += [(phase, t["event"]) for t in ev.evaluate(t0 + tick)]
            tick += 1
    assert (1, a.ALERT_FIRING) in trace and (2, a.ALERT_RESOLVED) in trace
    assert not [e for p, e in trace if p == 0]
    assert ev.firing() == [] and tap.names(a.ALERT_FIRING) and tap.names(a.ALERT_RESOLVED)


def test_recompile_sentinel_warm_expected_and_trip(pkg):
    a = pkg.alerts
    tap = _EventTap()
    store = pkg.timeseries.SeriesStore()
    dumps = []
    wd = types.SimpleNamespace(dump=lambda reason: dumps.append(reason))
    sent = a.RecompileSentinel(store, tap, steady=("decode", "admit"))
    t0 = 7000.0
    assert sent.observe({"decode": 0, "prefill": 1}, t0, wd) == []  # baseline
    assert sent.observe({"decode": 1, "prefill": 1}, t0 + 1, wd) == []  # warm first shape
    sent.expect()
    assert sent.observe({"decode": 2, "prefill": 1}, t0 + 2, wd) == []  # declared
    assert sent.observe({"decode": 2, "prefill": 5}, t0 + 3, wd) == []  # bucket ladder
    assert not dumps and not tap.names(a.ALERT_FIRING)
    assert sent.observe({"decode": 3, "prefill": 5}, t0 + 4, wd) == ["decode"]
    firing = sent.firing(t0 + 5)
    assert firing and firing[0]["alert"] == "alert.recompile" and firing[0]["program"] == "decode"
    assert dumps == ["alert:alert.recompile:decode"]
    assert store.get("compile.decode").latest()[1] == 3.0
    assert sent.firing(t0 + 4 + sent.HOLD_S + 1) == [] and tap.names(a.ALERT_RESOLVED)


def test_flightrec_dump_embeds_firing_alerts_and_series_tails(pkg):
    a = pkg.alerts
    store = pkg.timeseries.SeriesStore()
    ev = a.AlertEvaluator(store, None, scope="worker", rules=(a.BY_NAME["alert.queue_depth_high"],))
    t0 = 8000.0
    s = store.series("serve.queue_depth", "gauge")
    for i in range(5):
        s.append(t0 + i, 200.0)
        ev.evaluate(t0 + i)
    assert ev.firing()
    wd = pkg.flightrec.Watchdog(stall_s=60.0, dump_dir=None)
    wd.dump("unit-test")
    payload = wd.last_dump
    assert any(x["alert"] == "alert.queue_depth_high" for x in payload["alerts"])
    assert payload["alert_series"]["worker/serve.queue_depth"][-1] == [t0 + 4, 200.0]


def test_profcap_fires_once_on_injected_pressure(pkg, tmp_path, monkeypatch):
    monkeypatch.delenv("MAGGY_TPU_PROFCAP", raising=False)
    monkeypatch.setattr(pkg.memtrack, "device_memory", lambda: None)
    store = pkg.timeseries.SeriesStore()
    tel = pkg.recorder.Telemetry(worker="profcap-pressure-test")
    ledger = pkg.memtrack.MemoryLedger()
    ledger.register("params", 900 << 20)
    ledger.sim_limit_bytes = 1 << 30  # ~7.7% headroom: every tick a miss
    ev = pkg.alerts.AlertEvaluator(store, tel, scope="worker")
    pc = pkg.profcap.ProfileCapture(dump_dir=str(tmp_path))
    fired = []
    for tick in range(60):
        now = 50_000.0 + tick
        ledger.tick(store=store, telemetry=tel, now=now)
        path = pc.tick(ev.evaluate(now), now=now)
        if path:
            fired.append(path)
    assert len(fired) == 1
    with open(os.path.join(fired[0], "capture.json"), encoding="utf-8") as f:
        payload = json.load(f)
    assert payload["reason"] == "alert:alert.hbm_headroom"
    assert payload["profiler"] == "fallback"  # no accelerator here
    assert any("mem.headroom_miss" in k for k in payload["alert_series"]) and payload["threads"]
    assert pc.snapshot()["captures"] == 1 and pc.snapshot()["paths"] == fired


def test_profcap_cooldown_cap_and_env_flag(pkg, tmp_path, monkeypatch):
    monkeypatch.delenv("MAGGY_TPU_PROFCAP", raising=False)
    trans = [{"event": pkg.alerts.ALERT_FIRING, "alert": "alert.fragmentation"}]
    pc = pkg.profcap.ProfileCapture(dump_dir=str(tmp_path / "a"), cooldown_s=100.0, max_captures=2)
    assert pc.tick(trans, now=1000.0) is not None
    assert pc.tick(trans, now=1050.0) is None  # inside cooldown
    assert pc.tick(trans, now=1200.0) is not None
    assert pc.tick(trans, now=2000.0) is None  # over the per-process cap
    assert pc.tick([{"event": pkg.alerts.ALERT_FIRING, "alert": "alert.queue_depth_high"}], now=3000.0) is None
    monkeypatch.setenv("MAGGY_TPU_PROFCAP", "0")
    off = pkg.profcap.ProfileCapture(dump_dir=str(tmp_path / "b"))
    assert off.tick(trans, now=1.0) is None and off.snapshot()["enabled"] is False


def test_profcap_mode_follows_the_serving_device(tmp_path, monkeypatch):
    """The port's capture takes a torch.profiler trace only when its
    serving device is CUDA; on the CPU the JSON payload is the capture."""
    monkeypatch.delenv("MAGGY_TPU_PROFCAP", raising=False)
    trans = [{"event": alerts.ALERT_FIRING, "alert": "alert.hbm_headroom"}]
    pc = profcap.ProfileCapture(dump_dir=str(tmp_path), device=torch.device("cpu"))
    path = pc.tick(trans, now=1.0)
    assert pc.last_capture["profiler"] == "fallback"
    assert os.listdir(path) == ["capture.json"]


def test_scheduler_sentinel_trips_on_out_of_band_reconfigure():
    """A reconfigure through the scheduler seam re-baselines the sentinel;
    the same geometry change outside the seam adds a decode shape behind
    the scheduler's back and trips alert.recompile onto SSTATS."""
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.serve import Engine, Request, SamplingParams, Scheduler

    cfg = DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)
    model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    engine = Engine(cfg, model, num_slots=2, device="cpu")
    sched = Scheduler(engine)  # not started: tick driven by hand
    slot, _ = engine.admit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new=4)))
    engine.step()
    engine.release(slot)
    assert engine.compile_counts["decode"] == 1
    t0 = time.time()
    sched._metrics_tick(t0)
    assert sched.sentinel.firing() == []
    sched._pending_slots = 3
    sched._maybe_reconfigure()
    before = engine.compile_counts["decode"]
    sched._metrics_tick(t0 + 1)
    assert sched.sentinel.firing() == [], "declared reconfigure must not alert"
    engine.reconfigure(4)
    assert engine.compile_counts["decode"] > before
    sched._metrics_tick(t0 + 2)
    firing = sched.sentinel.firing()
    assert firing and firing[0]["alert"] == "alert.recompile"
    assert any(x["alert"] == "alert.recompile" for x in sched.stats()["alerts"])
