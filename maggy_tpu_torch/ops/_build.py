"""Build and load the hand-written CUDA kernels under ``maggy_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`. Nothing
includes PyTorch's headers, so a build takes seconds rather than minutes.

The build runs at first use, never at import: ``import maggy_tpu_torch``
works on a machine with no CUDA toolkit. Outputs go to
``maggy_tpu_torch/_build/<hash>/``, where the hash covers every source and
the compiler flags, so an edited kernel is rebuilt and a stale library is
never loaded. All sources compile in parallel, one ``nvcc`` each.

Three kernels serve both attention paths: ``ring_fwd``, ``ring_bwd_dq`` and
``ring_bwd_dkv`` compute one step of ring attention, and flash attention
over a whole sequence is the one-step ring (:mod:`maggy_tpu_torch.ops.flash`).
:func:`kernel` binds each library's C entry point ``mt_<name>``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("ring_fwd", "ring_bwd_dq", "ring_bwd_dkv")
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# argument types of each mt_<name>, as declared in csrc/<name>.cu
SIGNATURES = {
    "ring_fwd": [_P] * 10 + [_I] * 8 + [_F] + [_L] * 19 + [_P],
    "ring_bwd_dq": [_P] * 9 + [_I] * 8 + [_F] + [_L] * 22 + [_P],
    "ring_bwd_dkv": [_P] * 11 + [_I] * 8 + [_F] + [_L] * 25 + [_P],
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
# filled by build(): wall seconds of the compiles it ran, and ptxas_report()
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the attention kernels are built "
            "from source at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet; returns their
    paths. Raises with the compiler's output when a build fails."""
    out_dir = BUILD_ROOT / _digest()
    paths = {name: out_dir / f"lib{name}.so" for name in KERNELS}
    missing = [n for n, p in paths.items() if not p.exists()]
    if not missing:
        return paths
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (rc {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            (out_dir / f"{name}.ptxas.log").write_text(log)
            os.replace(tmp, paths[name])  # atomic: readers never see a partial file
    build_info.update(seconds=time.perf_counter() - t0, ptxas=ptxas_report())
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def parse_ptxas(log: str) -> Dict[str, Dict[str, object]]:
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas -v``
    output, by mangled name, and ptxas's performance notes (such as wgmma
    serialised) under ``"notes"``."""
    kernels: Dict[str, Dict[str, object]] = {}
    notes = []
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = kernels.setdefault(m.group(1), {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
        if "Performance Loss" in line or "warning" in line.lower():
            notes.append(line.strip())
    return {"kernels": kernels, "notes": notes}


def ptxas_report() -> Dict[str, Dict[str, object]]:
    """:func:`parse_ptxas` of each built kernel library, by source name."""
    out_dir = BUILD_ROOT / _digest()
    return {name: parse_ptxas((out_dir / f"{name}.ptxas.log").read_text())
            for name in KERNELS if (out_dir / f"{name}.ptxas.log").exists()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[name]))
            _libs[name] = lib
        return lib


def kernel(name: str):
    """The C entry point ``mt_<name>`` of kernel ``name``, typed, its library
    built and loaded on first use. It returns ``cudaGetLastError()`` after
    the launch, or -1 for a head_dim the kernel does not take."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(name), "mt_" + name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
