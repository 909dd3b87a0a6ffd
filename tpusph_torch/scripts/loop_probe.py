"""Per-block loop overhead of the SPH kernels' inner loop on the card, the
counterpart of `scripts/loop_probe.py`:

  V0 static trip, static loads
  V1 static trip, loads at offsets from the desc table
  V2 trip count from the desc table, static loads
  V3 trip count and offsets from the desc table (the kernels' fast path)
  V4 V3 with two blocks per loop iteration
  V5 V3 with the force kernel's op mix (three accumulators, rsqrt)

    python -m tpusph_torch.scripts.loop_probe [pt] [bl]

Each rate is the slope between R and 4R rounds, so the kernel's one copy of
its candidates into shared memory is in a call's time and not in the rate.
The kernel is `tpusph_torch/csrc/probes.cu` (`tpusph_loop_probe`); its first
design is timed beside it by `chip_smoke.py` and
`python -m tpusph_torch.scripts.loop_probe_sweep`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusph_torch.kernels.probes import VARIANTS, loop_probe
from tpusph_torch.scripts import cuda_device, slope, timed

R = 4096  # base rounds
CAP = 16384  # candidate buffer lanes


def run(variant, pt, bl):
    """(Gpair-lanes/s, seconds per block) of `variant` on a (pt, bl) block."""
    dev = cuda_device()
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.uniform(1, 9, (max(pt, 8), 4)).astype(np.float32)).to(dev)
    cand = torch.from_numpy(rng.uniform(1, 9, (8, CAP)).astype(np.float32)).to(dev)
    ts = {}
    for rounds in (R, 4 * R):
        desc = np.zeros((rounds + 8,), np.int16)
        desc[:rounds] = rng.integers(0, (CAP - bl) // 128, rounds)
        desc[rounds] = rounds  # dynamic trip count slot
        d = torch.from_numpy(desc).to(dev)
        ts[rounds] = timed(lambda: loop_probe(variant, d, t, cand, pt, bl), reps=5)
    dt = slope(ts[R], ts[4 * R], R, 4 * R)
    return pt * bl / dt / 1e9, dt


def main(argv=None):
    """Print each variant's rate; returns them as {variant: Gpair-lanes/s}."""
    argv = sys.argv[1:] if argv is None else argv
    pt = int(argv[0]) if len(argv) > 0 else 64
    bl = int(argv[1]) if len(argv) > 1 else 256
    print(f"device: {torch.cuda.get_device_name(cuda_device())}", flush=True)
    rates = {}
    for variant in VARIANTS:
        gl, dt = run(variant, pt, bl)
        rates[variant] = gl
        print(
            f"{variant} pt={pt} bl={bl}: {gl:7.2f} Gpair-lanes/s "
            f"({dt * 1e9:7.1f} ns/block)",
            flush=True,
        )
    return rates


if __name__ == "__main__":
    main()
