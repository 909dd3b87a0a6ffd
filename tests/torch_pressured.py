"""A state with the pressure live from its first step, for the port's tests
on the CPU and on the card (no jax import: the card's test file imports it).

Clusters of `per` particles, each within 0.2 h of a point of a cubic
lattice of spacing h near the box's middle. A cluster alone gives
rho ~ per x 28 (poly6 at r <= 0.2 h adds ~28 a neighbour with the scene's
constants), so from 40 a cluster max rho > rho0 = 1000 at step 0; at
spacing h the clusters' mean density is also above rho0, so they merge
into one pressured body rather than fly apart: about half of the
particles are still pressured after 10 steps at 4,096.
"""

from __future__ import annotations

import math

import torch

from tpusph_torch.core.config import default_config
from tpusph_torch.core.state import make_state, pad_state

# the scene's constants (sphbench/configs/dambreak-grid-262k.json)
SCENE = dict(h=0.1, box_dim=10.0, num_cells_per_dim=100, dt=0.01, mass=0.02,
             gas_constant=1.0, rest_density=1000.0, viscosity=1.0, gravity=-9.8,
             elasticity=0.5, eps=0.0001)


def clustered_position(n: int, per: int = 64, seed: int = 3, device="cpu") -> torch.Tensor:
    """f32[n, 3]: n // per clusters of `per` particles (the last takes the
    rest), each uniform in a cube of half-width 0.2 h / sqrt(3) around its
    lattice point, so within 0.2 h of it."""
    h = SCENE["h"]
    clusters = -(-n // per)
    side = math.ceil(clusters ** (1 / 3))
    i = torch.arange(clusters)
    centres = 3.0 + h * torch.stack([i // side**2, (i // side) % side, i % side], 1).float()
    g = torch.Generator().manual_seed(seed)
    jitter = (torch.rand((n, 3), generator=g) * 2 - 1) * (0.2 * h / math.sqrt(3))
    return (centres.repeat_interleave(per, 0)[:n] + jitter).to(device)


def clustered_state(n: int, padded: int | None = None, per: int = 64, seed: int = 3,
                    device="cpu"):
    """(cfg, FluidState at rest) of the clustered positions, padded to
    `padded` slots (cfg.padded_num_particles where None)."""
    cfg = default_config(n, chunk_size=min(n, 1024), **SCENE)
    st = make_state(clustered_position(n, per, seed, device))
    return cfg, pad_state(st, padded or cfg.padded_num_particles)
