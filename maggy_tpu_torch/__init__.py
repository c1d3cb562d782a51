"""maggy-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside :mod:`maggy_tpu`, which stays the reference. It
imports ``torch`` and never JAX or anything of ``maggy_tpu``. Its layout
follows the JAX package's (``ops/``, ``models/``, ``train/``, ``parallel/``,
``serve/``, ``telemetry/``); the TPU's
Pallas kernels become hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use (nothing CUDA-specific happens at import).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device given and no CUDA present they raise.
"""

__version__ = "0.1.0"
