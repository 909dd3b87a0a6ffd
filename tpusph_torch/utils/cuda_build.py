"""Build and load the CUDA kernels in `tpusph_torch/csrc/`.

Each `.cu` file is compiled by its own `nvcc` for sm_90a, all of them at
once, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The build runs at the first
call that needs a kernel, never at import, and lands in
`build/tpusph_torch/` at the repository root under a name keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once. A missing `nvcc` or a failed build raises.

Every entry point returns `cudaGetLastError()` after its launch; `check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusph_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# entry point → argtypes; every pointer and the stream are c_void_p so
# ctypes passes them as 64-bit values
SIGNATURES = {
    # key_sorted, n, queries, nq, num_cells, ranks, stream
    "tpusph_qrank": [P, I, P, I, I, P, P],
    # x, y, z, key, starts, n, C, num_cells, h2, scale, rho, stream
    "tpusph_density": [P, P, P, P, P, I, I, I, F, F, P, P],
    # x, y, z, vx, vy, vz, rho, p, n, r0, r1 (float4[n] each), stream
    "tpusph_force_pack": [P] * 8 + [I, P, P, P],
    # r0, r1 (tpusph_force_pack's rows), key, starts, n, C, num_cells, h, h2,
    # eps, mass, vk, mu, f (3·n field-major), walk (int64[3] or null), stream
    "tpusph_force": [P] * 4 + [I, I, I] + [F] * 6 + [P, P, P],
    # the density's first design (sph_baseline.cu), arguments as above
    "tpusph_density_baseline": [P, P, P, P, P, I, I, I, F, F, P, P],
    # x, n, streams, rounds, bf16, out, stream
    "tpusph_fma_probe": [P, I, I, I, I, P, P],
    # t, c, pt, rounds, bf16, out, stream
    "tpusph_density_mix": [P, P, I, I, I, P, P],
    # desc, t, cand, cap, pt, bl, rounds, variant, stage_d, out, stream
    "tpusph_loop_probe": [P, P, P, I, I, I, I, I, I, P, P],
    # the device branch (graph_cond.cu): stream, pred (int32[1]), child graph
    "tpusph_graph_if": [P, P, P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtpusph_torch-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet. Returns (path, seconds
    spent compiling, 0.0 when it was already built). The compiler's
    register and spill report goes to `<library>.log`."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all started together; then one link
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = [proc.communicate()[0] for _, proc in jobs]  # waits for every job
        for (cmd, proc), out in zip(jobs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        # link to a private name, then rename: concurrent builders never
        # load a half-written library
        lib = os.path.join(tmp, path.name)
        objects = [c[c.index("-o") + 1] for c, _ in jobs]
        cmd = [nvcc, "-shared", "-o", lib, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        path.with_suffix(".log").write_text("".join(log) + proc.stdout + proc.stderr)
        os.replace(lib, path)
    return path, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpusph_error_string.argtypes = [I]
    lib.tpusph_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().tpusph_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
