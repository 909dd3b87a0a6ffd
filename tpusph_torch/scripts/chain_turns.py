"""The 100-step fields chain at 262,144 grid init (`make_fields_chain`, one
CUDA-graph replay) on the first designs of its kernels and on the
redesigned ones, in turns on one card:

    python -m tpusph_torch.scripts.chain_turns [N]

Variants, run in the order given and then in reverse: `baseline` (the
first density and force kernels, `fused.density_baseline` /
`force_baseline`, with the engine's rank kernel), `first_rank` (the first
rank kernel, `qrank.rank_queries_baseline`, with the engine's density and
force) and `engine` (`qrank.rank_queries`, `fused.density` / `force`: what
the engine launches). Each variant captures its own chain; its
timesteps/s are 100 over the median wall time of 5 replays from grid init
up to a synchronize, and its device time by kernel comes from one
profiled replay. Prints one line per run with the card's name and power
limit.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.init import init_state
from tpusph_torch.engine import step as step_module
from tpusph_torch.engine.step import fields_from_state, make_fields_chain
from tpusph_torch.kernels import fused, qrank
from tpusph_torch.neighbors import cell_list
from tpusph_torch.scripts import card_line, cuda_device

STEPS = 100


# variant → (rank, density, force)
VARIANTS = {
    "baseline": (qrank.rank_queries, fused.density_baseline, fused.force_baseline),
    "first_rank": (qrank.rank_queries_baseline, fused.density, fused.force),
    "engine": (qrank.rank_queries, fused.density, fused.force),
}


def _use(rank, density, force) -> None:
    """Point the step at these kernels: it reads them from its modules."""
    cell_list.rank_queries = rank
    step_module.density, step_module.force = density, force


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 262_144
    dev = cuda_device()
    card = card_line()
    cfg = tuned_config(n)
    fs0 = fields_from_state(init_state(cfg, device=dev))
    saved = (cell_list.rank_queries, step_module.density, step_module.force)
    variants = list(VARIANTS)
    out = {}
    try:
        for variant in variants + variants[::-1]:
            _use(*VARIANTS[variant])
            chain = make_fields_chain(cfg, STEPS, dev)
            chain(fs0)  # capture and first replay
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                chain(fs0)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                chain(fs0)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in events) / 1e3

            def per_step(word):
                return sum(e.self_device_time_total for e in events if word in e.key) / 1e3 / STEPS

            rate = STEPS / statistics.median(walls)
            out.setdefault(variant, []).append(rate)
            print(f"chain turns N={n} {variant}: {rate:.3f} timesteps/s (median of 5 "
                  f"replays); device {device_ms:.3f} ms a replay; rank "
                  f"{per_step('qrank'):.4f}, density {per_step('density'):.4f}, force "
                  f"{per_step('force'):.4f} ms a step; {card}", flush=True)
    finally:
        _use(*saved)
    return out


if __name__ == "__main__":
    main()
