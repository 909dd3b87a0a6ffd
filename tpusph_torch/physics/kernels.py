"""SPH smoothing kernels as tensor functions.

Counterpart of `tpusph/physics/kernels.py`, with the reference's guards
(simulator.cu:84-130) and the JAX package's float32 operation order:
  * poly6: zero iff r² > h² (no self-exclusion: a particle's own poly6
    term is part of its density, simulator.cu:93).
  * spiky gradient: zero iff r² > h² or r < EPS_F (self excluded).
  * viscosity Laplacian: zero iff r > h or r < EPS_F.

Every constant goes through `f32` first, so a torch op sees the same
float32 value as `jnp.float32(...)` does. All functions broadcast over
leading dims and give no NaN at r = 0: 1/r is guarded before the select.
"""

from __future__ import annotations

import torch

from tpusph_torch.core.config import SimConfig, f32


def poly6(r2: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """(315/64πh⁹)(h²−r²)³ for r² ≤ h², else 0, from the squared distance."""
    h2 = f32(cfg.h2)
    diff = h2 - r2
    w = f32(cfg.d_kernel_coeff) * diff * diff * diff
    return torch.where(r2 <= h2, w, 0.0)


def spiky_grad(disp: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """∇W_spiky (simulator.cu:99-117): disp = x_i − x_j, shape [..., 3];
    returns disp·(−(45/πh⁶)(h−r)²/r), zero where r² > h² or r < EPS_F."""
    r2 = torch.sum(disp * disp, dim=-1)
    h = f32(cfg.h)
    r = torch.sqrt(r2)
    live = (r2 <= f32(cfg.h2)) & (r >= f32(cfg.eps))
    safe_r = torch.where(live, r, 1.0)
    hr = h - safe_r
    scale = torch.where(live, (-f32(cfg.v_kernel_coeff)) * (hr * hr) / safe_r, 0.0)
    return disp * scale[..., None]


def viscosity_lap(r: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """(45/πh⁶)(h−r) for EPS_F ≤ r ≤ h, else 0 (simulator.cu:119-130)."""
    h = f32(cfg.h)
    live = (r <= h) & (r >= f32(cfg.eps))
    return torch.where(live, f32(cfg.v_kernel_coeff) * (h - r), 0.0)


def pair_density(disp: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """mass · W_poly6(‖disp‖), one neighbour's density term
    (simulator.cu:178-179)."""
    r2 = torch.sum(disp * disp, dim=-1)
    return f32(cfg.mass) * poly6(r2, cfg)


def pressure_from_density(
    density: torch.Tensor, cfg: SimConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """ρ ← max(ρ, EPS_F); p = max(0, k(ρ − ρ₀)) (simulator.cu:186-189).
    Returns (clamped density, pressure)."""
    density = torch.clamp(density, min=f32(cfg.eps))
    pressure = torch.clamp(
        f32(cfg.gas_constant) * (density - f32(cfg.rest_density)), min=0.0
    )
    return density, pressure


def pair_force(
    disp: torch.Tensor,
    dv: torch.Tensor,
    p_i: torch.Tensor,
    p_j: torch.Tensor,
    rho_j: torch.Tensor,
    cfg: SimConfig,
) -> torch.Tensor:
    """One neighbour's force (simulator.cu:224-250):
      pressure:  −m (p_i + p_j)/(2 ρ_j) · ∇W_spiky(disp)
      viscosity:  μ m (v_j − v_i) ∇²W_visc(r) / ρ_j
    disp = x_i − x_j and dv = v_j − v_i are [..., 3]; scalars broadcast."""
    m = f32(cfg.mass)
    f_pressure = ((-m) * (p_i + p_j) / (2.0 * rho_j))[..., None] * spiky_grad(
        disp, cfg
    )
    r = torch.sqrt(torch.sum(disp * disp, dim=-1))
    f_visc = (f32(cfg.viscosity) * m * viscosity_lap(r, cfg) / rho_j)[..., None] * dv
    return f_pressure + f_visc
