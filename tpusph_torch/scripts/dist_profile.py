"""Where a sharded step's time goes on one card:

    python -m tpusph_torch.scripts.dist_profile [N] [halo_capacity]

One rank without a process group (`SlabComm` of size 1), 262,144 grid init
by default, backend `kernels`, in both forms of `dist/sharded.py`: elided
(what a line of one rank runs) and with TPUSPH_DIST_FULL_MACHINERY=1 (dead
halo buffers of `halo_capacity` rows a side, default 16,384, the splice
and the migration sort: what a middle rank pays, less the exchange). For
each, and for each form of the run (`make_sharded_run`: one CUDA-graph
replay of STEPS steps on a line of one rank, and `run.eager`, the Python
loop of eager steps): timesteps/s (wall time
up to a synchronize, the median of 5 runs from grid init), then one
profiled run: the device's busy share, device ms a step by kernel and
host ms a step by operator. Prints the card's name and power limit with
every figure.
"""

from __future__ import annotations

import itertools
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.init import init_state
from tpusph_torch.dist.comm import SlabComm
from tpusph_torch.dist.sharded import DistConfig, distribute_state, make_sharded_run
from tpusph_torch.scripts import card_line, cuda_device

STEPS = 100
MIGRATION_CAPACITY = 4096


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 262_144
    halo = int(argv[1]) if len(argv) > 1 else 16_384
    dev = cuda_device()
    card = card_line()
    cfg = tuned_config(n)
    comm = SlabComm(dev)
    whole = init_state(cfg, device="cpu")
    out = {}
    for (label, full), form in itertools.product((("elided", "0"), ("full machinery", "1")),
                                                 ("graphs", "eager")):
        os.environ["TPUSPH_DIST_FULL_MACHINERY"] = full
        dcfg = DistConfig(1, cfg.padded_num_particles, halo, MIGRATION_CAPACITY)
        run = make_sharded_run(cfg, dcfg, comm, STEPS)
        run = run if form == "graphs" else run.eager
        start = distribute_state(whole, cfg, dcfg, comm)
        run(start)  # warm
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(start)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(start)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        events = prof.key_averages()
        device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
        device_ms = sum(e.self_device_time_total for e in device) / 1e3
        out[f"{label}, {form}"] = dict(timesteps_per_s=STEPS / wall,
                                       device_ms_per_step=device_ms / STEPS)
        print(f"sharded one rank, {label}, {form}, N={n}: {STEPS / wall:.3f} timesteps/s "
              f"({wall / STEPS * 1e3:.4f} ms a step, median of 5 runs of {STEPS} steps); "
              f"profiled run {prof_wall * 1e3:.3f} ms, device {device_ms:.3f} ms, busy "
              f"{device_ms / 1e3 / prof_wall:.3f}; {card}")
        print("  device ms a step by kernel: " + "; ".join(
            f"{e.key[:90]} {e.self_device_time_total / 1e3 / STEPS:.4f} (x{e.count / STEPS:.1f})"
            for e in device[:14]))
        print("  host ms a step by operator: " + "; ".join(
            f"{e.key[:50]} {e.self_cpu_time_total / 1e3 / STEPS:.4f} (x{e.count / STEPS:.1f})"
            for e in host[:14]))
    os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)
    return out


if __name__ == "__main__":
    main()
