"""Time ``chip_smoke.py``'s ``dist.lagom`` phase in two checkouts, in turn, on one card.

Each checkout given runs in a process of its own: it builds its kernels,
runs the ``train`` phase (the reference the rank is held to) and then
``dist.lagom`` (the ``train`` configuration as one NCCL rank under
``lagom(DistributedConfig(sharding="fsdp", num_executors=1))``), and prints
one JSON line with the rank's step, ``train``'s step, their ratio, the
rank's peak and the phase's seconds. Give the checkouts in an order that
brackets each by the other, so that a drift of the card shows::

    python3 tools/group_binding_ab.py OLD NEW NEW OLD

Used to compare a process group bound to its card (``device_id``) with one
bound to none, which is the only difference in ``dist.lagom`` between two
checkouts that differ in ``core/executors/distributed.py::_init_group``.
Needs one CUDA card; every line goes to standard output, the card's
``nvidia-smi`` line first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ONE = r"""
import json, sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
import torch
import chip_smoke as cs
from maggy_tpu_torch.ops import _build
from maggy_tpu_torch.models import DecoderConfig

card = cs.card_line()
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ref = {}
_, train_ms, _ = cs.phase_train(torch, cs.N_LAYERS, cs.S, cs.TRAIN_STEPS, card, False, ref)
t = time.perf_counter()
rank = cs.phase_dist_lagom(torch, DecoderConfig.llama3_8b(n_layers=cs.N_LAYERS), cs.S, cs.TRAIN_STEPS, card,
                           ref, train_ms)
print("AB " + json.dumps(dict(tree=tree, dist_step_ms=rank["step_ms"], train_step_ms=train_ms,
                              ratio=rank["step_ms"] / train_ms, peak_gib=rank["peak_gib"],
                              phase_s=time.perf_counter() - t, card=card)), flush=True)
"""


def main(trees) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for tree in trees:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, "-c", ONE, tree], capture_output=True, text=True, cwd=tree,
                             timeout=600)
        lines = [ln[3:] for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n", file=sys.stderr)
            return 1
        rows.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    print(json.dumps({"runs": rows}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
