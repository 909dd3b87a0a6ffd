"""Loader for the native C++ host library (`native/sphnative.cpp`).
Counterpart of `tpusph/utils/native.py`.

The unchanged source is compiled at first use with g++ into
`build/tpusph_torch/` (the port's build directory, never the JAX
package's `native/build/`), under a name keyed by a hash of the source,
and bound with ctypes. It is written to a private name and renamed, so
concurrent builders never load a half-written file. Every caller has a
numpy path that gives the same bytes, so a missing compiler costs speed
and the libc `rand()` replay, nothing else: `get_lib` then returns None.
This is host code; it has no part in the device path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tpusph_torch.utils.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "native" / "sphnative.cpp"
ABI_VERSION = 2

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsphnative-{digest}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = os.path.join(tmp, path.name)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", lib, str(SRC)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(lib, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


@functools.cache
def get_lib():
    """ctypes handle to the native library, or None where the source, the
    compiler or the expected ABI is missing. Tried once per process."""
    if not SRC.exists():
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.sph_reference_random_init.argtypes = [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, _F32P,
    ]
    lib.sph_grid_init.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float, _F32P]
    lib.sph_grid_init.restype = ctypes.c_int
    lib.sph_render_frame.argtypes = [_F32P, ctypes.c_int, _U8P]
    lib.sph_render_packed.argtypes = [_I32P, ctypes.c_int, _U8P]
    for fn in (lib.sph_reference_random_init, lib.sph_render_frame, lib.sph_render_packed):
        fn.restype = None
    lib.sph_native_abi_version.restype = ctypes.c_int
    if lib.sph_native_abi_version() != ABI_VERSION:
        return None
    return lib


def reference_random_positions(n: int, box_dim: float, seed: int = -1):
    """The reference's libc `rand()` placement, bit for bit
    (simulator.cu:430-437). seed=-1 keeps the process's `rand()` state (the
    reference never seeds: glibc starts at seed 1). f32[n, 3], or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n, 3), np.float32)
    lib.sph_reference_random_init(n, box_dim, seed, out.ctypes.data_as(_F32P))
    return out


def render_frame_native(positions: np.ndarray):
    """The native rasterizer (display.cpp parity): uint8[600, 800, 3], or
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    img = np.empty((600, 800, 3), np.uint8)
    lib.sph_render_frame(pos.ctypes.data_as(_F32P), pos.shape[0], img.ctypes.data_as(_U8P))
    return img


def render_packed_native(packed: np.ndarray):
    """The native rasterizer over device-projected packed pixels
    (`viz/project.py`'s layout): uint8[600, 800, 3], or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(packed, np.int32)
    img = np.empty((600, 800, 3), np.uint8)
    lib.sph_render_packed(p.ctypes.data_as(_I32P), p.shape[0], img.ctypes.data_as(_U8P))
    return img
