"""Simulation diagnostics, the observability the reference lacks (its only
instrumentation is the Times report and device-printf OOB warnings).
Counterpart of `tpusph/bench/diagnostics.py`.

Tensors in, Python numbers out: the ten values are computed on the
state's device, packed into one float64 vector (exact for the int32
counts) and copied to the host once, the call's only synchronise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig, f32
from tpusph_torch.core.state import FluidState
from tpusph_torch.neighbors.grid import compute_keys


class Diagnostics(NamedTuple):
    num_valid: int
    kinetic_energy: float  # ½ m Σ|v|²
    momentum: tuple[float, float, float]  # m Σ v
    max_speed: float
    mean_density: float  # valid only
    max_density: float
    occupied_cells: int
    max_cell_occupancy: int


def compute_diagnostics(state: FluidState, cfg: SimConfig) -> Diagnostics:
    v = state.valid
    vel = torch.where(v[:, None], state.velocity, 0.0)
    m = f32(cfg.mass)
    speed2 = (vel * vel).sum(dim=1)
    nvalid = v.sum()
    keys = compute_keys(state.position, v, cfg).key
    counts = keys.new_zeros(cfg.num_cells + 1).index_add_(0, keys.long(), torch.ones_like(keys))
    counts = counts[: cfg.num_cells]
    rho = torch.where(v, state.density, 0.0)
    packed = torch.stack(
        [
            t.to(torch.float64)
            for t in (
                nvalid,
                0.5 * m * speed2.sum(),
                *(m * vel.sum(dim=0)),
                speed2.max().sqrt(),
                rho.sum() / nvalid.clamp(min=1),
                rho.max(),
                (counts > 0).sum(),
                counts.max(),
            )
        ]
    ).tolist()
    n, ke, px, py, pz, vmax, rmean, rmax, cells, occ = packed
    return Diagnostics(int(n), ke, (px, py, pz), vmax, rmean, rmax, int(cells), int(occ))


def format_diagnostics(d) -> str:
    """One-line report (after printGridList's occupancy dump,
    simulator.cu:22-41)."""
    return (
        f"N={int(d.num_valid)} KE={float(d.kinetic_energy):.4f} "
        f"|p|={float(sum(x * x for x in d.momentum)) ** 0.5:.4f} "
        f"v_max={float(d.max_speed):.3f} "
        f"rho mean/max={float(d.mean_density):.1f}/{float(d.max_density):.1f} "
        f"cells={int(d.occupied_cells)} occ_max={int(d.max_cell_occupancy)}"
    )
