"""One SPH timestep (kernelBuildGrid → kernelUpdatePressureAndDensity →
kernelUpdateForces → kernelUpdatePositions, simulator.cu:462-497).
Counterpart of `tpusph/engine/step.py`.

Backends with the same physics:
  * step_allpairs — O(N²) oracle (tests, small N).
  * step_kernels  — sort, starts table from the rank kernel, then the
    density and force kernels over the sorted order, scattered back to the
    caller's particle order. The counterpart of `step_pallas`.

The step is functional: it returns a new state and leaves its input as it
was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.state import FluidState
from tpusph_torch.kernels.fused import density, force
from tpusph_torch.neighbors.allpairs import density_allpairs, forces_allpairs
from tpusph_torch.neighbors.cell_list import CellList, build_cell_list
from tpusph_torch.physics.integrate import integrate
from tpusph_torch.physics.kernels import pressure_from_density


class StepAux(NamedTuple):
    """Per-step diagnostics."""

    oob_count: torch.Tensor | int  # particles outside the grid
    # Candidates beyond a window capacity. The kernels walk every window to
    # its end and the rank kernel has no window, so this is always 0; it
    # stays for parity with the JAX package's StepAux.
    window_overflow: int


def _finish(state: FluidState, force_, density_, pressure, cfg: SimConfig) -> FluidState:
    """Integrate valid particles; freeze invalid padding slots."""
    x, v = integrate(state.position, state.velocity, force_, density_, cfg)
    valid3 = state.valid[:, None]
    return FluidState(
        position=torch.where(valid3, x, state.position),
        velocity=torch.where(valid3, v, state.velocity),
        force=force_,
        density=density_,
        pressure=pressure,
        valid=state.valid,
    )


def step_allpairs(state: FluidState, cfg: SimConfig):
    """Oracle timestep: all O(N²) pairs, same physics and integration."""
    rho, p = density_allpairs(state.position, state.valid, cfg)
    f = forces_allpairs(state.position, state.velocity, rho, p, state.valid, cfg)
    return _finish(state, f, rho, p, cfg), StepAux(oob_count=0, window_overflow=0)


def build_phase(state: FluidState, cfg: SimConfig) -> CellList:
    """Neighbour-structure build, the timed "grid construction" phase
    (kernelBuildGrid, simulator.cu:505-513)."""
    return build_cell_list(state.position, state.valid, cfg)


def update_phase_kernels(state: FluidState, cl: CellList, cfg: SimConfig):
    """Density → forces → integrate, the timed "SPH update" phase
    (simulator.cu:516-529), on the density and force kernels. Returns
    (new_state, aux)."""
    xyz = state.position[cl.perm].T.contiguous()  # (3, n) sorted rows
    vxyz = state.velocity[cl.perm].T.contiguous()
    valid_s = cl.valid_sorted
    raw = density(*xyz, cl.key_sorted, cl.starts, cfg)
    rho_s, p_s = pressure_from_density(raw, cfg)
    rho_s = torch.where(valid_s, rho_s, 1.0)
    p_s = torch.where(valid_s, p_s, 0.0)
    f_s = force(*xyz, *vxyz, rho_s, p_s, cl.key_sorted, cl.starts, cfg)
    f_s = torch.where(valid_s, f_s, 0.0).T

    # scatter back: sorted[i] is original[perm[i]]
    n = state.num_slots
    force_ = f_s.new_empty((n, 3)).index_copy_(0, cl.perm, f_s)
    density_ = rho_s.new_empty(n).index_copy_(0, cl.perm, rho_s)
    pressure = p_s.new_empty(n).index_copy_(0, cl.perm, p_s)
    new_state = _finish(state, force_, density_, pressure, cfg)
    aux = StepAux(oob_count=cl.oob_count, window_overflow=cl.starts_overflow)
    return new_state, aux


def step_kernels(state: FluidState, cfg: SimConfig):
    """Production timestep: build, then update on the kernels."""
    return update_phase_kernels(state, build_phase(state, cfg), cfg)


BACKENDS = {
    "allpairs": step_allpairs,
    "kernels": step_kernels,
}


def make_step(cfg: SimConfig, backend: str = "kernels", device="cpu"):
    """`state -> (state, aux)` for states on `device`. On a CUDA device the
    kernels are built here, so the first step does not pay for the build."""
    cfg.validate()
    fn = BACKENDS[backend]
    device = torch.device(device)
    if device.type == "cuda":
        from tpusph_torch.utils import cuda_build

        cuda_build.library()

    def step(state: FluidState):
        if state.device.type != device.type:
            raise ValueError(f"state is on {state.device}, step was made for {device}")
        return fn(state, cfg)

    return step
