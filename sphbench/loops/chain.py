"""Loop `chain`: one call of `make_fields_chain(cfg, steps, device)` a run
(one CUDA-graph replay on a card, the start state's fields copied in),
then the host synchronizes; runs back to back, one caller. A run is timed
on the device's clock, from a mark before the call to one after it
(reached when the run's work is done).

A run has failed where the chain's window overflow, summed over its
steps, is not zero. The chain returns no out-of-grid count; its rows stay
in the box by the walls' clamp, and the correctness check holds every
row.

Judged by `phase_gap_max` and `phase_gap_p99` (`compare.py`): the chain
returns its rows in cell order, with no particle identity.

A loop is a file `loops/<loop>.py` with a class `Loop(config, traffic,
start, device)` (`run(record)` one whole run, returning its output;
`result(output)`, the output as numpy for the comparison; `steps` and
`n`) and `numbers(got, reference, config)`, the numbers `compare.py`
judges it by; a traffic file's `loop` names it.
"""

from __future__ import annotations

import torch

from sphbench import compare, port
from sphbench.window import Marks, Record, sync
from tpusph_torch.engine.step import FieldsState, make_fields_chain


class Loop:
    def __init__(self, config: dict, traffic: dict, start: dict, device):
        self.device = torch.device(device)
        self.cfg = port.sim_config(config)
        self.steps = int(traffic["steps"])
        self.n = int(config["num_particles"])
        s = port.state(start, self.cfg)
        self.fs0 = FieldsState(*(a[:, i].contiguous() for a in (s.position, s.velocity)
                                 for i in range(3)), s.valid)
        self.chain = make_fields_chain(self.cfg, self.steps, self.device)
        self.marks = Marks(self.device, 1)

    def run(self, rec: Record):
        """One run; returns its output (FieldsState)."""
        self.marks.start(0)
        with torch.profiler.record_function("sphbench.launch"):
            out, ovf = self.chain(self.fs0)
        self.marks.end(0)
        with torch.profiler.record_function("sphbench.sync"):
            sync(self.device)
        rec.run_s.extend(self.marks.seconds(1))
        rec.runs += 1
        rec.steps += self.steps
        if int(ovf) != 0:
            rec.failed += 1
        return out

    def result(self, out) -> dict:
        """The valid rows' positions and velocities, as numpy, in the
        chain's cell order."""
        v = out.valid
        return {"position": torch.stack([out.x[v], out.y[v], out.z[v]], 1).cpu().numpy(),
                "velocity": torch.stack([out.vx[v], out.vy[v], out.vz[v]], 1).cpu().numpy()}


def numbers(got: dict, ref: dict, config: dict) -> dict:
    return compare.phase_numbers(got["position"], got["velocity"], ref["position"],
                                 ref["velocity"], float(config["dt"]))
