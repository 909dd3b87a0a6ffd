"""Arithmetic-rate probe on the card, the counterpart of
`scripts/vpu_microbench.py`: the FMA rate in f32 and bf16 against the
number of independent chains, and the rate of the SPH density inner loop's
op mix in pair-lanes per second.

    python -m tpusph_torch.scripts.vpu_microbench

Each rate is a slope: the FMA probe is timed at R and 4R rounds, the
density mix at R/4 and R, and the difference is divided by the extra
rounds, so launch and fixed costs drop out. The kernels are
`tpusph_torch/csrc/probes.cu`; the density mix does its compares in f32
and its arithmetic in the probe's dtype, as the TPU kernel does.
"""

from __future__ import annotations

import torch

from tpusph_torch.kernels.probes import density_mix, fma_probe
from tpusph_torch.scripts import cuda_device, slope, timed

R = 20_000
SUB = 256


def run_fma(dtype, streams):
    """(Tfma/s, seconds per round) of `streams` chains on a (SUB, 128) block."""
    x = torch.ones((SUB, 128), dtype=dtype, device=cuda_device())
    ts = {rounds: timed(lambda: fma_probe(x, streams, rounds), reps=6)
          for rounds in (R, 4 * R)}
    dt = slope(ts[R], ts[4 * R], R, 4 * R)
    ops = streams * SUB * 128  # fmas per round
    return ops / dt / 1e12, dt


def run_density_mix(dtype, pt):
    """(Gpair-lanes/s, seconds per round) of the op mix on a (pt, 128) block."""
    dev = cuda_device()
    t = torch.ones((max(pt, 8), 4), dtype=dtype, device=dev)
    c = torch.ones((8, 128), dtype=dtype, device=dev)
    ts = {rounds: timed(lambda: density_mix(t, c, pt, rounds), reps=6)
          for rounds in (R // 4, R)}
    dt = slope(ts[R // 4], ts[R], R // 4, R)
    return pt * 128 / dt / 1e9, dt


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def main():
    """Print every rate; returns them as {(probe, dtype name, streams or
    pt): rate}, Tfma/s for the FMA probe and Gpair-lanes/s for the mix."""
    print(f"device: {torch.cuda.get_device_name(cuda_device())}", flush=True)
    rates = {}
    print(f"fma slope bench (SUB={SUB}, R={R}):", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for streams in (1, 4, 8):
            tops, dt = run_fma(dtype, streams)
            rates["fma", dtype_name(dtype), streams] = tops
            print(f"  {dtype_name(dtype):9s} streams={streams}: "
                  f"{tops:6.3f} Tfma/s ({dt*1e9:7.1f} ns/round)", flush=True)
    print("density-mix slope bench (pair-lanes/s):", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for pt in (8, 64, 128, 256):
            gl, dt = run_density_mix(dtype, pt)
            rates["density_mix", dtype_name(dtype), pt] = gl
            print(f"  {dtype_name(dtype):9s} pt={pt:4d}: {gl:7.2f} Gpair-lanes/s "
                  f"({dt*1e9:7.1f} ns/block)", flush=True)
    return rates


if __name__ == "__main__":
    main()
