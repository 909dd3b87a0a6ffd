"""The ctypes table of the kernel library (`cuda_build.SIGNATURES`) against
the C entry points in `tpusph_torch/csrc/`, read from the sources on the
CPU. `library()` types every entry of the table when it loads the library,
so a row whose entry point is gone or whose arguments differ in number or
kind from the source would otherwise show only on a card: ctypes passes
whatever the row says.

Kinds: a pointer, a CUDA stream or a CUDA graph is c_void_p; an int is
c_int; a float is c_float. `tpusph_error_string`, which returns a string
and which `library()` types by hand, is the one entry point outside the
table."""

import ctypes
import re

import pytest

from tpusph_torch.utils import cuda_build

HAND_TYPED = {"tpusph_error_string"}
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _entries() -> dict[str, list[list[str]]]:
    """{name: [parameter list of each definition]} of every `extern "C" int`
    entry point in csrc/."""
    found = {}
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            params = [p.strip() for p in params.split(",") if p.strip()]
            found.setdefault(name, []).append(params)
    return found


def _kind(param: str):
    """The ctypes type a C parameter declaration is passed as."""
    if "*" in param or param.split()[0] in ("cudaStream_t", "cudaGraph_t"):
        return ctypes.c_void_p
    if re.fullmatch(r"(const\s+)?int\s+\w+", param):
        return ctypes.c_int
    if re.fullmatch(r"(const\s+)?float\s+\w+", param):
        return ctypes.c_float
    raise ValueError(f"no ctypes kind for the parameter {param!r}")


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_signature_matches_its_entry_point(name):
    defs = _entries().get(name, [])
    assert len(defs) == 1, f"{name}: {len(defs)} definitions in csrc/"
    params = defs[0]
    argtypes = cuda_build.SIGNATURES[name]
    assert len(params) == len(argtypes), f"{name}: {len(params)} parameters in the source"
    assert [_kind(p) for p in params] == argtypes, name


def test_every_entry_point_has_a_signature():
    entries = _entries()
    assert entries, "no extern \"C\" int entry point found in csrc/"
    assert set(entries) - HAND_TYPED == set(cuda_build.SIGNATURES)
