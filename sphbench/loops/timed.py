"""Loop `timed`: the CUDA original's `-m time` run. `Simulator.setup(start
state)`, `steps` calls of `simulate_and_time(times)`, each timed on the
device's clock between marks before and after the call (both on an idle
compute stream, since each phase ends in its fence), then
`get_position()`, the last step's positions waited for on the host; runs
back to back, one caller. A run is timed on the host's clock.

A run has failed where the last step's out-of-grid count or window
overflow is not zero.

Judged by `position_gap_*` (the host positions keep the particle order)
and `density_gap_*` (the last step's density) of `compare.py`.
"""

from __future__ import annotations

import time

import torch

from sphbench import compare, port
from sphbench.window import Marks, Record, sync
from tpusph_torch.engine.simulator import Simulator


class Loop:
    def __init__(self, config: dict, traffic: dict, start: dict, device):
        self.device = torch.device(device)
        self.cfg = port.sim_config(config)
        self.steps = int(traffic["steps"])
        self.n = int(config["num_particles"])
        self.state0 = port.state(start, self.cfg)
        self.sim = Simulator(self.cfg, backend="kernels", device=self.device)
        self.marks = Marks(self.device, self.steps)

    def run(self, rec: Record):
        """One run; returns (host positions, the last step's density)."""
        sim, marks = self.sim, self.marks
        t0 = time.perf_counter()
        with torch.profiler.record_function("sphbench.setup_state"):
            sim.setup(self.state0)
        for k in range(self.steps):
            marks.start(k)
            sim.simulate_and_time(rec.times)
            marks.end(k)
        with torch.profiler.record_function("sphbench.get_position"):
            pos = sim.get_position()
        rec.run_s.append(time.perf_counter() - t0)
        sync(self.device)  # the last mark
        rec.step_s.extend(marks.seconds(self.steps))
        rec.runs += 1
        rec.steps += self.steps
        aux = sim.last_aux
        if int(aux.oob_count) != 0 or int(aux.window_overflow) != 0:
            rec.failed += 1
        return pos, sim.state.density[: self.n]

    def result(self, out) -> dict:
        pos, density = out
        return {"position": pos.copy(), "density": density.cpu().numpy()}


def numbers(got: dict, ref: dict, config: dict) -> dict:
    return compare.identity_numbers(got["position"], got["density"], ref["position"],
                                    ref["density"])
