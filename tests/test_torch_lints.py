"""The repo's seven static lints (``tools/check_*.py``) hold on the port.

Each tool is loaded by its file path, as ``tests/test_concurrency_lint.py``
loads them, and run over the whole ``maggy_tpu_torch/`` tree, whose walk
takes in every module of the port (the ablation slice's among them): each
must report no violation (rc 0). ``tools/`` itself is used as it is.
"""

import importlib.util
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "maggy_tpu_torch")
LINTS = ("concurrency", "host_sync", "exception_hygiene", "no_bare_print", "chaos_kinds",
         "telemetry_names", "knob_registry")


def _load(name):
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(name, os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve string annotations here
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("lint", LINTS)
def test_lint_passes_on_the_port(lint, capsys):
    rc = _load(f"check_{lint}").main([PORT])
    assert rc == 0, capsys.readouterr().out


def test_the_walk_covers_the_ablation_slice():
    """The lints' shared walker (``tools/analysis``) reaches every module
    of the ablation slice: none is pruned from their coverage."""
    _load("check_concurrency")  # puts tools/ on the path
    from analysis.framework import iter_py_files

    walked = {os.path.relpath(p, PORT) for p in iter_py_files(PORT)}
    for rel in ("ablation/__init__.py", "ablation/masking.py", "ablation/ablationstudy.py",
                "ablation/ablator/__init__.py", "ablation/ablator/abstractablator.py", "ablation/ablator/loco.py",
                "core/driver/ablation.py", "config/ablation.py", "models/bert.py"):
        assert rel in walked, rel
