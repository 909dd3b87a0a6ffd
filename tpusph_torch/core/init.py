"""Initial particle placement (Simulator::setup, simulator.cu:411-460).

Counterpart of `tpusph/core/init.py`:
  * grid: cubic lattice, spacing 0.9h, origin (h,h,h), z-fastest fill,
    truncated at N. Pure numpy, so it is bit-equal to the JAX package's.
  * random: uniform in [1, box_dim-1]³ from a seeded `torch.Generator`.
    It cannot reproduce the JAX package's `jax.random` draws; to run both
    packages on one random state, build it in one and carry it across
    with `state_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.state import FluidState, make_state, pad_state


def _lattice_nx(cfg: SimConfig) -> int:
    """Lattice points per axis, nx = floor((box-2h)/0.9h)+1 in float32
    (simulator.cu:441-443)."""
    h = np.float32(cfg.h)
    spacing = np.float32(0.9) * h
    return int(np.floor((np.float32(cfg.box_dim) - 2 * h) / spacing)) + 1


def grid_positions(cfg: SimConfig) -> np.ndarray:
    """Lattice as simulator.cu:438-453: position = h + 0.9h·(x,y,z), filled
    z-fastest (x outer, y middle, z inner) until count == N."""
    h = np.float32(cfg.h)
    spacing = np.float32(0.9) * h
    nx = _lattice_nx(cfg)
    n = cfg.num_particles
    if n > lattice_capacity(cfg):
        raise ValueError(
            f"num_particles={n} exceeds lattice capacity {lattice_capacity(cfg)}"
        )
    idx = np.arange(n, dtype=np.int64)
    x = idx // (nx * nx)
    y = (idx // nx) % nx
    z = idx % nx
    pos = np.stack([x, y, z], axis=1).astype(np.float32)
    return (h + spacing * pos).astype(np.float32)


def lattice_capacity(cfg: SimConfig) -> int:
    """Particles the 0.9h grid lattice holds in the box; N above this needs
    random init."""
    return _lattice_nx(cfg) ** 3


def random_positions(cfg: SimConfig, seed: int = 0) -> torch.Tensor:
    """Uniform in [1, box_dim-1]³ (simulator.cu:430-437), drawn on the CPU
    from a generator seeded with `seed`, so every device gets the same
    positions."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((cfg.num_particles, 3), generator=gen, dtype=torch.float32)
    return u * (cfg.box_dim - 2.0) + 1.0


def init_state(
    cfg: SimConfig, random_init: bool = False, seed: int = 0, device="cpu"
) -> FluidState:
    """Padded initial state for `cfg` on `device`."""
    if random_init:
        pos = random_positions(cfg, seed)
    else:
        pos = torch.from_numpy(grid_positions(cfg))
    state = make_state(pos.to(device))
    return pad_state(state, cfg.padded_num_particles)
