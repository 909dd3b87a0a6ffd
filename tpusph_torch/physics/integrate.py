"""Semi-implicit Euler with reflective box walls (kernelUpdatePositions,
simulator.cu:258-318). Counterpart of `tpusph/physics/integrate.py`:
  1. v += dt · (f/ρ + g), gravity an acceleration on y;
  2. x += dt · v;
  3. per-axis clamp to [h, box−h]; a clamped axis gets v *= −elasticity;
  4. per-component deadband: |v_c| < EPS_F → 0.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusph_torch.core.config import SimConfig, f32


def _bounds(cfg: SimConfig) -> tuple[float, float]:
    """(h, box − h), the box − h difference taken in float32."""
    return f32(cfg.h), float(np.float32(cfg.box_dim) - np.float32(cfg.h))


def _reflect(p, v, cfg: SimConfig):
    lo, hi = _bounds(cfg)
    out = (p < lo) | (p > hi)
    p = torch.clamp(p, lo, hi)
    v = torch.where(out, v * f32(-cfg.elasticity), v)
    v = torch.where(torch.abs(v) < f32(cfg.eps), 0.0, v)
    return p, v


def integrate(position, velocity, force, density, cfg: SimConfig):
    """Returns (new_position, new_velocity); shapes [N,3],[N,3],[N,3],[N]."""
    g = torch.tensor(
        [0.0, f32(cfg.gravity), 0.0], dtype=torch.float32, device=position.device
    )
    v = velocity + f32(cfg.dt) * (force / density[:, None] + g)
    x = position + f32(cfg.dt) * v
    return _reflect(x, v, cfg)


def integrate_fields(x, y, z, vx, vy, vz, fx, fy, fz, density, cfg: SimConfig):
    """integrate() on 1-D field rows with the same per-component float32
    arithmetic (the x and z components add gravity 0.0, an identity).
    Returns (x, y, z, vx, vy, vz)."""
    dt = f32(cfg.dt)

    def axis(p, v, f, grav):
        v = v + dt * (f / density + grav)
        return _reflect(p + dt * v, v, cfg)

    x, vx = axis(x, vx, fx, 0.0)
    y, vy = axis(y, vy, fy, f32(cfg.gravity))
    z, vz = axis(z, vz, fz, 0.0)
    return x, y, z, vx, vy, vz
