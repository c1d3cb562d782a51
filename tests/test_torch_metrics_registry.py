"""The port's metric-name registry (``maggy_tpu_torch/telemetry/metrics.py``).

Walks ``maggy_tpu_torch/`` as ``tools/check_telemetry_names.py`` walks
``maggy_tpu/``, with the same AST rules, against the PORT's registry: every
literal ``gauge``/``count``/``histogram``/``event`` name it emits is
registered under its kind, every f-string name has a registered dynamic
prefix, and every ``"alert.*"`` literal names a rule of the port's
``telemetry/alerts.py``. The port's registry holds no name, unit or prefix
that the JAX package's lacks, and loads by file path (stdlib only)."""

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import check_telemetry_names as lint  # noqa: E402
from analysis import load_module_from_path  # noqa: E402

PORT = os.path.join(ROOT, "maggy_tpu_torch")


@pytest.fixture(scope="module")
def port_registry():
    return load_module_from_path("maggy_tpu_torch_metrics_registry",
                                 os.path.join(PORT, "telemetry", "metrics.py"))


@pytest.fixture(scope="module")
def jax_registry():
    return lint.load_registry(ROOT)


def port_sources():
    return sorted(os.path.relpath(os.path.join(d, f), PORT)
                  for d, _, files in os.walk(PORT) for f in files if f.endswith(".py"))


def test_registry_is_stdlib_only():
    with open(os.path.join(PORT, "telemetry", "metrics.py")) as f:
        tree = ast.parse(f.read())
    imports = {alias.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
               for alias in node.names}
    imports |= {node.module.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module}
    assert imports <= {"__future__"}, imports


@pytest.mark.parametrize("kind", ["gauge", "count", "histogram", "event"])
def test_port_registry_is_within_jax(port_registry, jax_registry, kind):
    assert port_registry.BY_KIND[kind] <= jax_registry.BY_KIND[kind]
    assert port_registry.BY_KIND[kind]


def test_port_units_and_prefixes_are_jax_and_complete(port_registry, jax_registry):
    assert lint.check_units(port_registry) == []
    assert all(jax_registry.UNITS[n] == u for n, u in port_registry.UNITS.items())
    assert set(port_registry.DYNAMIC_PREFIXES) <= set(jax_registry.DYNAMIC_PREFIXES)


def test_the_fleet_names_are_registered(port_registry):
    for name in ("fleet.healthy_replicas", "fleet.breaker_open", "fleet.brownout_level", "fleet.replicas",
                 "fleet.draining", "fleet.at_capacity", "serve.handoff_ms"):
        assert name in port_registry.GAUGES, name
    for name in ("fleet.shed", "fleet.quarantined", "fleet.requeued", "fleet.routed", "fleet.retry_deferred",
                 "fleet.brownout_clamped", "fleet.breaker_opened", "fleet.breaker_closed", "fleet.scale_events",
                 "tier.affinity_hits", "tier.affinity_misses"):
        assert name in port_registry.COUNTERS, name
    assert {"serve.handoff_ms", "fleet.drain_ms"} <= port_registry.HISTOGRAMS
    assert {"req.accepted", "req.dispatched", "req.requeued", "req.shed", "req.completed", "req.prefilled",
            "req.handoff", "fleet.scale.up", "fleet.scale.down", "fleet.scale.admitted",
            "fleet.scale.retired"} <= port_registry.EVENTS


@pytest.fixture(scope="module")
def alert_names():
    alerts = load_module_from_path("maggy_tpu_torch_alerts_registry", os.path.join(PORT, "telemetry", "alerts.py"))
    return {r.name for r in alerts.RULES} | {alerts.ALERT_FIRING, alerts.ALERT_RESOLVED}


@pytest.mark.parametrize("path", port_sources())
def test_every_emitted_name_is_registered(port_registry, alert_names, path):
    with open(os.path.join(PORT, path)) as f:
        violations = lint.check_source(f.read(), path, port_registry, alert_names)
    assert violations == []


def test_the_walk_catches_a_typo(port_registry):
    src = 'def f(tel):\n    tel.gauge("serve.ttft_m", 1.0)\n    tel.count(f"nope.{x}")\n    "abc".count("a")\n'
    assert [line for line, _ in lint.check_source(src, "x.py", port_registry)] == [2, 3]
