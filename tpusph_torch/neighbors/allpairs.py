"""O(N²) all-pairs neighbour oracle. Counterpart of
`tpusph/neighbors/allpairs.py`.

The cell edge equals h, so every pair with r ≤ h lies in the 27-cell
stencil and every other pair contributes exactly 0 through the kernel
cutoffs: this path computes what the cell-list path computes, and serves
as its oracle at small N. Targets are processed in row chunks, so peak
memory is O(B·N).
"""

from __future__ import annotations

import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.physics.kernels import pair_density, pair_force, pressure_from_density


def density_allpairs(position, valid, cfg: SimConfig):
    """ρ_i = Σ_j m·W_poly6 over valid j, self included, then the ρ/p clamps
    (simulator.cu:161-189). Invalid rows get ρ = 1, p = 0. Returns
    (density, pressure)."""
    rho = torch.empty_like(position[:, 0])
    p = torch.empty_like(rho)
    for c0 in range(0, position.shape[0], cfg.chunk_size):
        c1 = min(position.shape[0], c0 + cfg.chunk_size)
        disp = position[c0:c1, None, :] - position[None, :, :]
        contrib = torch.where(valid[None, :], pair_density(disp, cfg), 0.0)
        r, pr = pressure_from_density(contrib.sum(dim=1), cfg)
        rho[c0:c1] = torch.where(valid[c0:c1], r, 1.0)
        p[c0:c1] = torch.where(valid[c0:c1], pr, 0.0)
    return rho, p


def forces_allpairs(position, velocity, density, pressure, valid, cfg: SimConfig):
    """f_i = Σ_j pressure + viscosity terms over valid j
    (simulator.cu:192-256); invalid rows are 0."""
    f = torch.empty_like(position)
    for c0 in range(0, position.shape[0], cfg.chunk_size):
        c1 = min(position.shape[0], c0 + cfg.chunk_size)
        disp = position[c0:c1, None, :] - position[None, :, :]
        dv = velocity[None, :, :] - velocity[c0:c1, None, :]
        fij = pair_force(
            disp, dv, pressure[c0:c1, None], pressure[None, :], density[None, :], cfg
        )
        fi = torch.where(valid[None, :, None], fij, 0.0).sum(dim=1)
        f[c0:c1] = torch.where(valid[c0:c1, None], fi, 0.0)
    return f
