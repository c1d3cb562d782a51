"""maggy-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside :mod:`maggy_tpu`, which stays the reference. It
imports ``torch`` and never JAX or anything of ``maggy_tpu``. Its layout
follows the JAX package's (``ops/``, ``models/``, ``train/``, ``parallel/``,
``serve/``, ``telemetry/``) and so does its ``lagom()`` control plane
(``experiment``, ``config/``, ``core/``, ``optimizer/``); the TPU's
Pallas kernels become hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use (nothing CUDA-specific happens at import).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device given and no CUDA present they raise.
"""

__version__ = "0.1.0"

from maggy_tpu_torch.reporter import Reporter
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial

__all__ = ["__version__", "Searchspace", "Trial", "Reporter"]


def __getattr__(name):
    # lazy, as in the JAX package: ``import maggy_tpu_torch`` starts no
    # driver machinery. importlib (not ``from maggy_tpu_torch import ...``)
    # so a missing submodule raises ImportError instead of recursing here
    import importlib

    if name == "experiment":
        return importlib.import_module("maggy_tpu_torch.experiment")
    if name == "AblationStudy":
        return importlib.import_module("maggy_tpu_torch.ablation").AblationStudy
    raise AttributeError(f"module 'maggy_tpu_torch' has no attribute {name!r}")
