"""The port stands alone: no JAX, no ``maggy_tpu``, no quiet CPU fallback.

``maggy_tpu_torch`` (and ``chip_smoke.py``) import nothing of JAX, flax,
optax or the JAX package ``maggy_tpu``, not even its JAX-free modules; and
its entry points run on CUDA unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "maggy_tpu"}


def _forbidden(module: str) -> bool:
    # "maggy_tpu" and "maggy_tpu.x" are the JAX package; "maggy_tpu_torch" is not
    return module.split(".")[0] in FORBIDDEN_ROOTS


def test_forbidden_matches_the_jax_package_only():
    assert _forbidden("maggy_tpu") and _forbidden("maggy_tpu.ops.flash")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("maggy_tpu_torch") and not _forbidden("maggy_tpu_torch.train")


def test_import_pulls_in_no_jax_and_no_cuda_build():
    code = (
        "import sys\n"
        "import maggy_tpu_torch, maggy_tpu_torch.ops, maggy_tpu_torch.ops.flash\n"
        "import maggy_tpu_torch.models, maggy_tpu_torch.train, maggy_tpu_torch.convert\n"
        "import maggy_tpu_torch.util, maggy_tpu_torch.ops.ring_flash\n"
        "import maggy_tpu_torch.parallel, maggy_tpu_torch.parallel.spec\n"
        "import maggy_tpu_torch.serve, maggy_tpu_torch.models.generate, maggy_tpu_torch.telemetry\n"
        "import maggy_tpu_torch.experiment, maggy_tpu_torch.core.driver.hpo, maggy_tpu_torch.core.rpc\n"
        "import maggy_tpu_torch.optimizer, maggy_tpu_torch.telemetry.recorder, maggy_tpu_torch.models.mlp\n"
        "from maggy_tpu_torch.ops import _build\n"
        "print(sorted(sys.modules))\n"
        "print(len(_build._libs), 'triton' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout.splitlines()
    modules = ast.literal_eval(out[0])
    assert [m for m in modules if _forbidden(m)] == []
    assert "maggy_tpu_torch.train" in modules and "maggy_tpu_torch.serve.engine" in modules
    assert out[1] == "0 False"  # no kernel library loaded, no triton


def _sources():
    files = sorted((REPO / "maggy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract is not observable here")


def test_trainer_and_model_need_cuda_unless_told(no_cuda):
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.train import Trainer, adamw
    from maggy_tpu_torch.util import seed_everything

    cfg = DecoderConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Decoder(cfg, device="meta"), adamw(1e-3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seed_everything(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cuda")
    Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cpu")  # asked for: fine


def test_engine_needs_cuda_unless_told(no_cuda):
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.serve import Engine

    cfg = DecoderConfig.tiny(dtype=torch.float32)
    weights = Decoder(cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, weights)
    Engine(cfg, weights, num_slots=1, device="cpu")  # asked for: fine


def test_flash_kernels_raise_without_cuda(no_cuda):
    from maggy_tpu_torch.ops import flash

    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="not CUDA"):
        flash.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="not CUDA"):
        flash.flash_bwd_dq(q, k, k, q, q, lse)
    with pytest.raises(ValueError, match="not CUDA"):
        flash.flash_bwd_dkv(q, k, k, q, q, lse)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def test_kernel_build_raises_without_nvcc(no_cuda, monkeypatch):
    from maggy_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
