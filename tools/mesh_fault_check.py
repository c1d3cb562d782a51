"""Plant a fault in a copy of the port's mesh code and read ``chip_smoke.py``'s
``dist.mesh`` phase on it: what the phase's limits let through.

On a host with two or more CUDA cards (four for the fsdp x tp group):

    python3 tools/mesh_fault_check.py [--faults NAME,...] [--work DIR]

It runs the ``train`` phase and ``dist.lagom`` once from this checkout (the
one-rank run every mesh rank is held to), then ``dist.mesh`` on this
checkout and on one copy per fault (``chip_smoke.py`` and the port), each
copy in its own directory under ``--work`` (default: a temporary
directory) with one source line changed. Every run is its own process.
For each it prints one JSON line: the fault, whether the phase passed,
and per spec, over its ranks, the largest deviation from the one-rank run
of the loss, the grad norm and each gradient group's norm, and of the
trainer's grad norm from the groups', beside the phase's limits. The faults:

* ``norm_grad_rank1``: rank 1 zeroes its shards of the norm scales'
  gradients after the backward (one rank's share of a small leaf lost).
* ``replica_norm``: the grad norm counts a replicated gradient once per
  replica (a norm over ``data`` or ``tensor`` replicas summed as shards).

The ``dist.mesh`` runs skip the tp-local kernel timings, which no fault
touches. Exits 0 when the unchanged checkout passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fault -> (file, the line as it is, the line with the fault); each line
# must occur exactly once
FAULTS = {
    "norm_grad_rank1": (
        "maggy_tpu_torch/train/trainer.py",
        "        grads = [p.grad for p in state.model.parameters() if p.grad is not None]\n",
        "        grads = [p.grad for p in state.model.parameters() if p.grad is not None]\n"
        "        if self.mesh is not None and torch.distributed.get_rank() == 1:\n"
        "            for n, p in state.model.named_parameters():\n"
        "                if n.endswith('scale') and p.grad is not None:\n"
        "                    (p.grad.to_local() if hasattr(p.grad, 'to_local') else p.grad).zero_()\n",
    ),
    "replica_norm": (
        "maggy_tpu_torch/train/trainer.py",
        "                if not (placement.is_replicate() or placement.is_partial()):",
        "                if not placement.is_partial():",
    ),
}
NO_TIMINGS = (
    "chip_smoke.py",
    "    tp_local = {f\"tp{tp}\": tp_local_kernels(torch, tp) for tp in (2, 4)}\n",
    "    tp_local = {}\n",
)

REFERENCE = """
import json, sys, torch
import chip_smoke as c
from maggy_tpu_torch.models import DecoderConfig
from maggy_tpu_torch.ops import _build
_build.build()
card = c.card_line()
ref = {}
_, step_ms, _ = c.phase_train(torch, c.N_LAYERS, c.S, c.TRAIN_STEPS, card, False, ref)
single = c.phase_dist_lagom(torch, DecoderConfig.llama3_8b(n_layers=c.N_LAYERS), c.S, c.TRAIN_STEPS, card, ref,
                            step_ms)
json.dump(single, open(sys.argv[1], "w"))
"""

MESH = """
import json, sys, torch
import chip_smoke as c
from maggy_tpu_torch.ops import _build
_build.build()
single = json.load(open(sys.argv[1]))
try:
    c.phase_dist_mesh(torch, c.N_LAYERS, c.S, c.TRAIN_STEPS, c.card_line(), single)
except SystemExit as e:
    print("failed:", e, flush=True)
"""


def _plant(root: str, path: str, old: str, new: str) -> None:
    full = os.path.join(root, path)
    with open(full) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{path}: the line to change occurs {text.count(old)} times, not once: {old!r}")
    with open(full, "w") as f:
        f.write(text.replace(old, new))


def _run(cwd: str, code: str, *args: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=900)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"run in {cwd} exited with {proc.returncode}:\n{proc.stdout[-4000:]}")
    return proc.stdout


def _summary(fault: str, out: str) -> dict:
    line = next((ln for ln in out.splitlines() if ln.startswith("dist.mesh: ")), None)
    if line is None:
        raise SystemExit(f"{fault}: dist.mesh printed no result:\n{out[-4000:]}")
    res = json.loads(line[len("dist.mesh: "):])
    specs = {}
    for row in res.get("ranks", []):
        s = specs.setdefault(row["spec"], dict(loss_rel=0.0, grad_norm_rel=0.0, group_grad_norm_rel={},
                                               grad_norm_count_rel=0.0, ok=True))
        for key in ("loss_rel", "grad_norm_rel", "grad_norm_count_rel"):
            s[key] = max(s[key], row[key])
        for group, rel in row["group_grad_norm_rel"].items():
            s["group_grad_norm_rel"][group] = max(s["group_grad_norm_rel"].get(group, 0.0), rel)
        s["ok"] = s["ok"] and row["ok"]
    return dict(fault=fault, ok=res["ok"], ran=res["ran"], tol=res.get("tol"), specs=specs,
                phase_s=res.get("phase_s"), card=res.get("card"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", default=",".join(FAULTS), help="comma-separated fault names")
    ap.add_argument("--work", default=None, help="directory for the copies (default: a temporary one)")
    args = ap.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]
    unknown = sorted(set(faults) - set(FAULTS))
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; known: {sorted(FAULTS)}")
    work = args.work or tempfile.mkdtemp(prefix="mesh_fault_")
    os.makedirs(work, exist_ok=True)
    single = os.path.join(work, "single.json")
    _run(REPO, REFERENCE, single)
    sound = None
    for fault in [None, *faults]:
        root = os.path.join(work, fault or "none")
        shutil.rmtree(root, ignore_errors=True)
        # what chip_smoke.py runs: itself and the port (its built kernels too)
        shutil.copytree(os.path.join(REPO, "maggy_tpu_torch"), os.path.join(root, "maggy_tpu_torch"))
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
        _plant(root, *NO_TIMINGS)
        if fault is not None:
            _plant(root, *FAULTS[fault])
        row = _summary(fault or "none", _run(root, MESH, single))
        print(json.dumps(row), flush=True)
        if fault is None:
            sound = row["ok"]
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
