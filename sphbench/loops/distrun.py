"""Loop `distrun`: the z-slab engine's production loop on one rank.
`DistSimulator(cfg, backend="kernels", device)` with no process group (a
line of one rank) and the whole multi-rank machinery
(TPUSPH_DIST_FULL_MACHINERY=1, set in this process before the simulator
is made; the configuration states `mesh` "z", `ranks` 1 and `machinery`
"full"): dead halo buffers, the spliced combined rows, the migration
category with its rotation and the conditional sort node, the compaction
and the counters' reduce, without the exchange. The start state is distributed once, at
construction (`setup`), and that block stays on the card.

A run: `sim.state` set to the start block (the graph copies it into its
own tensors, and never writes the block), `sim.run(steps)` (one
CUDA-graph replay of `make_sharded_run`, its counters read once), then
one `collect_state`: position and velocity by pid as host numpy, fresh
arrays each run. Runs back to back, one caller; a run is timed on the
host's clock.

A run has failed where the chunk's out-of-grid count is not zero or the
collect has a NaN row (a pid lost).

Judged by `position_gap_max` and `position_gap_p99` (|x - x_ref| by pid,
as in `compare.identity_numbers`) and `velocity_gap_max` and
`velocity_gap_p99` (dt·|v - v_ref| by pid, so a velocity off by one
step's displacement counts as much as a position).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from sphbench import port
from sphbench.window import Record
from tpusph_torch.dist.sharded import collect_state
from tpusph_torch.dist.simulator import DistSimulator


class Loop:
    def __init__(self, config: dict, traffic: dict, start: dict, device):
        if (config.get("mesh"), config.get("ranks"), config.get("machinery")) != ("z", 1, "full"):
            raise ValueError("loop distrun runs one rank of a z-slab line, the whole machinery")
        os.environ["TPUSPH_DIST_FULL_MACHINERY"] = "1"
        self.device = torch.device(device)
        self.cfg = port.sim_config(config)
        self.steps = int(traffic["steps"])
        self.n = int(config["num_particles"])
        self.sim = DistSimulator(self.cfg, backend="kernels", device=self.device)
        self.sim.setup(port.state(start, self.cfg))
        self.state0 = self.sim.state

    def run(self, rec: Record):
        """One run; returns the collect ({position, velocity} by pid)."""
        sim = self.sim
        t0 = time.perf_counter()
        sim.state = self.state0
        with torch.profiler.record_function("sphbench.dist_run"):
            sim.run(self.steps)
        with torch.profiler.record_function("sphbench.collect"):
            got = collect_state(sim.state, self.n, sim.comm)
        rec.run_s.append(time.perf_counter() - t0)
        rec.runs += 1
        rec.steps += self.steps
        lost = np.isnan(got["position"]).any() or np.isnan(got["velocity"]).any()
        if int(sim.last_aux.oob_count) != 0 or lost:
            rec.failed += 1
        return got

    def result(self, out) -> dict:
        return {"position": out["position"], "velocity": out["velocity"]}


def numbers(got: dict, ref: dict, config: dict) -> dict:
    pos = np.asarray(got["position"], dtype=np.float64)
    vel = np.asarray(got["velocity"], dtype=np.float64)
    if (pos.shape != ref["position"].shape or vel.shape != ref["velocity"].shape
            or not np.isfinite(pos).all() or not np.isfinite(vel).all()):
        return {k: math.inf for k in ("position_gap_max", "position_gap_p99",
                                      "velocity_gap_max", "velocity_gap_p99")}
    d = np.linalg.norm(pos - ref["position"], axis=1)
    dv = float(config["dt"]) * np.linalg.norm(vel - ref["velocity"], axis=1)
    return {"position_gap_max": float(d.max()), "position_gap_p99": float(np.percentile(d, 99)),
            "velocity_gap_max": float(dv.max()), "velocity_gap_p99": float(np.percentile(dv, 99))}
