"""What every loop hands the port: its configuration and its start state.

The port is reached only through `tpusph_torch.core.config`,
`tpusph_torch.core.state`, `tpusph_torch.engine.step` and
`tpusph_torch.engine.simulator`.
"""

from __future__ import annotations

import dataclasses

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.state import make_state, pad_state

# the configuration file's keys that set the port's SimConfig
SIM_KEYS = ("h", "box_dim", "num_cells_per_dim", "dt", "mass", "gas_constant",
            "rest_density", "viscosity", "gravity", "elasticity", "eps")


def sim_config(config: dict):
    return tuned_config(int(config["num_particles"]), **{k: config[k] for k in SIM_KEYS})


def state(start: dict, cfg):
    """The port's padded FluidState of the init's start state."""
    s = make_state(start["position"])
    s = dataclasses.replace(s, velocity=start["velocity"].to(s.velocity.dtype).clone())
    return pad_state(s, cfg.padded_num_particles)
