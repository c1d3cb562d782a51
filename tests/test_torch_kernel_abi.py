"""The ctypes binding of each hand-written kernel against its C prototype.

``maggy_tpu_torch.ops._build.SIGNATURES`` lists the argument types ctypes
passes to each ``extern "C" int mt_<name>(...)`` entry point in
``maggy_tpu_torch/csrc/<name>.cu``. A mismatch compiles and loads without a
word, and then a pointer typed as ``c_int`` is cut to 32 bits, or every
argument after a missing one lands in the wrong register. The kernels build
only on a CUDA machine; this test reads the sources, so it runs anywhere.
"""

import ctypes
import re
from pathlib import Path

import pytest

from maggy_tpu_torch.ops import _build

PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+mt_(\w+)\s*\(([^)]*)\)', re.S)


def ctypes_of(param: str):
    """The ctypes type that carries one C parameter, e.g. ``const void* q``."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0]  # drop the parameter's name
    types = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
    if kind not in types:
        raise ValueError(f"no ctypes mapping for C parameter {param!r}")
    return types[kind]


def prototypes(text: str):
    """{name: [ctypes type per parameter]} of every ``extern "C" int mt_*``."""
    return {name: [ctypes_of(p) for p in params.split(",")] for name, params in PROTOTYPE.findall(text)}


@pytest.mark.parametrize("name", _build.KERNELS)
def test_signature_matches_the_c_prototype(name):
    found = prototypes((_build.CSRC / f"{name}.cu").read_text())
    assert list(found) == [name], f"{name}.cu should define exactly mt_{name}"
    want = found[name]
    got = list(_build.SIGNATURES[name])
    assert len(got) == len(want), f"mt_{name}: {len(want)} C parameters, {len(got)} ctypes types"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, f"mt_{name} parameter {i}: C needs {w.__name__}, SIGNATURES has {g.__name__}"


def test_every_entry_point_is_bound():
    defined = {}
    for path in sorted(Path(_build.CSRC).glob("*.cu")):
        defined.update(prototypes(path.read_text()))
    assert set(defined) == set(_build.KERNELS) == set(_build.SIGNATURES)


def test_the_parser_sees_a_cut_pointer():
    """The check is not vacuous: a scratch pointer typed as int is caught."""
    text = 'extern "C" int mt_x(\n    const void* q, void* scratch,\n    int n, float s, long long st, void* stream) {'
    assert prototypes(text)["x"] == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_longlong, ctypes.c_void_p]
    wrong = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    assert prototypes(text)["x"] != wrong
