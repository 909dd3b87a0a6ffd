"""The start state of `init` "late", made from `--seed`: the dam break
after impact.

The grid init of `inits/grid.py` from the seed (the CUDA original's
lattice and the seed's jitter, at rest), then the configuration's
`start_steps` steps of the plain reference (`reference/sph.py`) in
float32 on `device`: the position and velocity after them. The port
takes no part in making the state; the reference that judges the cell
runs on from the same state. Raises where the last of those steps has no
particle with rho > rho0, so that a cell on this state never measures a
fluid without pressure.

The reference's working memory is freed, and on a card the peak of
allocated memory is reset, before the state is handed over: a cell's
`memory_peak_bytes` is the port's, as on the grid init.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from sphbench.reference import sph


def _grid():
    """`inits/grid.py`, the file beside this one."""
    path = Path(__file__).with_name("grid.py")
    spec = importlib.util.spec_from_file_location("sphbench_inits_grid_under_late", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def state(config: dict, seed: int, device) -> dict:
    """{"position", "velocity"} after the reference's `start_steps` steps
    from the seed's grid init, and "density", the last step's (f32[N])."""
    grid = _grid().start(config, seed, device)
    out = sph.run(grid["position"], config, int(config["start_steps"]),
                  velocity=grid["velocity"])
    return {k: out[k] for k in ("position", "velocity", "density")}


def start(config: dict, seed: int, device) -> dict:
    s = state(config, seed, device)
    top, rho0 = float(s["density"].max()), float(config["rest_density"])
    if not top > rho0:
        raise ValueError(f"no pressure at the start state: after {config['start_steps']} "
                         f"reference steps from seed {seed} the largest density is {top!r}, "
                         f"not above rest_density {rho0!r}")
    out = {"position": s["position"], "velocity": s["velocity"]}
    del s
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return out
