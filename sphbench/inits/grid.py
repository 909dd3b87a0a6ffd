"""The start state of `init` "grid", made from `--seed`.

The lattice is the CUDA original's grid init (`src/simulator.cu:438-453`):
spacing 0.9h in float32, nx = floor((box - 2h) / spacing) + 1 points an
axis, position h + spacing·(x, y, z), filled z-fastest (x outer, z inner)
until N. The seed draws a uniform jitter of each coordinate in
[-jitter, +jitter] (the configuration's `jitter`, under `assumed`): it
changes the bits and not the regime, since it is far below the spacing.
Velocity is zero. Both the port and the reference are handed this one
state.

An init is a file `inits/<init>.py` with `start(config, seed, device)`
returning {"position": f32[N, 3], "velocity": f32[N, 3]} on `device`;
the configuration's `init` names it.
"""

from __future__ import annotations

import numpy as np
import torch


def lattice_nx(config: dict) -> int:
    h = np.float32(config["h"])
    spacing = np.float32(config["lattice_spacing_h"]) * h
    return int(np.floor((np.float32(config["box_dim"]) - 2 * h) / spacing)) + 1


def start(config: dict, seed: int, device) -> dict:
    """The grid lattice plus the seed's jitter, at rest, made on the device
    in a few calls."""
    n = int(config["num_particles"])
    nx = lattice_nx(config)
    if n > nx**3:
        raise ValueError(f"num_particles={n} exceeds the lattice's {nx ** 3}")
    h = float(np.float32(config["h"]))
    spacing = float(np.float32(config["lattice_spacing_h"]) * np.float32(config["h"]))
    idx = torch.arange(n, device=device)
    cells = torch.stack([idx // (nx * nx), (idx // nx) % nx, idx % nx], dim=1)
    pos = h + spacing * cells.to(torch.float32)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((n, 3), generator=gen, device=device, dtype=torch.float32)
    pos = pos + float(config["jitter"]) * (2.0 * u - 1.0)
    return {"position": pos, "velocity": torch.zeros_like(pos)}
