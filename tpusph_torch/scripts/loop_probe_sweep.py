"""The loop probe's launch shape, swept on the card: the design search behind
the constants of `tpusph_torch/csrc/probes.cu`.

    python -m tpusph_torch.scripts.loop_probe_sweep [--json PATH] [pt ...]

Each configuration is a copy of `probes.cu` with other values of kLoopUnroll,
kLoopWarps, kLoopTargets and kLoopResident, built on its own by `nvcc` (all at once) under `build/tpusph_torch/sweep/`. For every
pt (default 8, 64, 128; bl 256), configuration and variant it prints the
device ms of a call at R rounds (10 calls in one CUDA graph) and the rate by
the slope between R and 4R, with the candidates staged in shared memory and
read from device memory, the configurations timed in turns (forwards, then
backwards; the smaller time of the two passes). The library's own build
(`probes.loop_probe`) runs in the same turns. Every configuration's V0-V5 at
R are first held against the library's, which the GPU tests hold to
`probes.loop_probe_plain`, at rounds·eps. `--json PATH` also writes the
table there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpusph_torch.kernels import probes
from tpusph_torch.kernels.launch import stream_of
from tpusph_torch.scripts import card_line, cuda_device, graph_ms, slope, timed
from tpusph_torch.scripts.loop_probe import CAP, R
from tpusph_torch.utils import cuda_build

# (rounds in flight, warps a block, targets a thread, blocks an SM is to hold:
# 0 leaves the second launch bound out); the first is probes.cu's own
CONFIGS = [
    (32, 2, 1, 4), (16, 2, 1, 4), (8, 2, 1, 4), (32, 1, 1, 4), (32, 4, 1, 4), (32, 4, 1, 2),
    (32, 2, 2, 4), (32, 1, 2, 4), (32, 1, 4, 4), (32, 2, 1, 0), (16, 1, 1, 0),
]
NAMES = ("kLoopUnroll", "kLoopWarps", "kLoopTargets", "kLoopResident")


def build_all(configs):
    """{config: ctypes library} of probes.cu rebuilt with each config's constants."""
    root = cuda_build.BUILD_DIR / "sweep"
    source = (cuda_build.CSRC / "probes.cu").read_text()
    jobs = {}
    for cfg in configs:
        text = source
        for name, value in zip(NAMES, cfg):
            text, count = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
            if count != 1:
                raise RuntimeError(f"{name} not found once in probes.cu")
        folder = root / "_".join(map(str, cfg))
        folder.mkdir(parents=True, exist_ok=True)
        (folder / "probes.cu").write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-shared",
               "-o", str(folder / "probes.so"), str(folder / "probes.cu")]
        jobs[cfg] = (folder, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for cfg, (folder, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {cfg}:\n{log}")
        # ptxas's report of the loop probe's kernels alone
        report = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                            r"Used (\d+) registers", log, flags=re.S)
        regs = [int(r) for name, _, r in report if "loop_probe_kernel" in name]
        spills = [int(sp) for name, sp, _ in report if "loop_probe_kernel" in name]
        print(f"built {cfg}: loop kernels use {min(regs)}-{max(regs)} registers, spill stores "
              f"up to {max(spills)} B", flush=True)
        lib = ctypes.CDLL(str(folder / "probes.so"))
        lib.tpusph_loop_probe.argtypes = cuda_build.SIGNATURES["tpusph_loop_probe"]
        lib.tpusph_loop_probe.restype = ctypes.c_int
        libs[cfg] = lib
    return libs


def call(lib, variant, desc, t, cand, pt, bl, stage):
    out = torch.empty((pt, bl), dtype=torch.float32, device=t.device)
    stage_d = probes.loop_stage_blocks(variant, cand, bl) if stage else 0
    err = lib.tpusph_loop_probe(desc.data_ptr(), t.data_ptr(), cand.data_ptr(), cand.shape[1],
                                pt, bl, desc.shape[0] - 8, int(variant[1]), stage_d,
                                out.data_ptr(), stream_of(t.device))
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", type=Path, default=None, help="also write the table here")
    parser.add_argument("pt", type=int, nargs="*", default=[8, 64, 128])
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    pts = args.pt
    dev = cuda_device()
    card = card_line()
    bl = 256
    libs = build_all(CONFIGS)
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.uniform(1, 9, (max(pts), 4)).astype(np.float32)).to(dev)
    cand = torch.from_numpy(rng.uniform(1, 9, (8, CAP)).astype(np.float32)).to(dev)
    descs = {}
    for rounds in (R, 4 * R):
        d = np.zeros((rounds + 8,), np.int16)
        d[:rounds] = rng.integers(0, (CAP - bl) // 128, rounds)
        d[rounds] = rounds
        descs[rounds] = torch.from_numpy(d).to(dev)

    fns = {"library, staged": lambda v, d, pt: probes.loop_probe(v, d, t, cand, pt, bl)}
    for cfg, lib in libs.items():
        for stage in (True, False):
            fns[f"{cfg} {'staged' if stage else 'device memory'}"] = (
                lambda v, d, pt, lib=lib, stage=stage: call(lib, v, d, t, cand, pt, bl, stage))

    eps = torch.finfo(torch.float32).eps
    for name, fn in fns.items():
        for v in probes.VARIANTS:
            got, want = fn(v, descs[R], pts[-1]), fns["library, staged"](v, descs[R], pts[-1])
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=R * eps, atol=0, msg=f"{name} {v}")
    print(f"every configuration equals the library's at {R} rounds within rounds x eps",
          flush=True)

    table = []
    for pt in pts:
        best = {}
        order = list(fns)
        for name in order + order[::-1]:
            for v in probes.VARIANTS:
                ts = {rounds: timed(lambda: fns[name](v, descs[rounds], pt), 5)
                      for rounds in (R, 4 * R)}
                ts["ms"] = graph_ms(lambda: fns[name](v, descs[R], pt), reps=5)
                key = (name, v)
                if key not in best or ts["ms"] < best[key]["ms"]:
                    best[key] = ts
        for name in order:
            row = {"pt": pt, "bl": bl, "config": name, "card": card, "ms": {}, "rate": {}}
            for v in probes.VARIANTS:
                ts = best[(name, v)]
                row["ms"][v] = ts["ms"]
                row["rate"][v] = pt * bl / slope(ts[R], ts[4 * R], R, 4 * R) / 1e9
            table.append(row)
            print(f"pt {pt:3d} {name:38s} ms at {R}: "
                  + " ".join(f"{row['ms'][v]:.4f}" for v in probes.VARIANTS)
                  + " | Gpair-lanes/s: "
                  + " ".join(f"{row['rate'][v]:7.1f}" for v in probes.VARIANTS)
                  + f" | {card}", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(table, indent=1))
    return table


if __name__ == "__main__":
    main()
