"""The numbers that decide `correct`, worked out against the reference.

- `phase_gap_max`, `phase_gap_p99` (the chain, whose rows come back in
  cell order with no particle identity): every particle of either side is
  paired with the nearest particle of the other in phase space, (x, dt·v),
  so a velocity off by one step's displacement counts as much as a
  position; the widest and the 99th percentile of the distances over both
  directions. A particle lost, doubled or moved shows in one direction.
- `position_gap_max`, `position_gap_p99` (the timed step, whose host
  positions keep the particle order): |x_program - x_reference| per
  particle.
- `density_gap_max`, `density_gap_p99` (the timed step): the widest and
  the 99th percentile of |rho_program - rho_reference| / rho_reference of
  the last step's density.

A non-finite value on the program's side makes every number infinite.
Each compared number has its limit in `limits/<workload>.json`; a cell
without limits is not correct.
"""

from __future__ import annotations

import math

import numpy as np


def phase_numbers(pos, vel, ref_pos, ref_vel, dt: float) -> dict[str, float]:
    from scipy.spatial import cKDTree

    a = np.concatenate([pos, dt * vel], axis=1).astype(np.float64)
    b = np.concatenate([ref_pos, dt * ref_vel], axis=1).astype(np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return {"phase_gap_max": math.inf, "phase_gap_p99": math.inf}
    d_ab, _ = cKDTree(b).query(a, workers=-1)
    d_ba, _ = cKDTree(a).query(b, workers=-1)
    d = np.concatenate([d_ab, d_ba])
    return {"phase_gap_max": float(d.max()), "phase_gap_p99": float(np.percentile(d, 99))}


def identity_numbers(pos, density, ref_pos, ref_density) -> dict[str, float]:
    pos = np.asarray(pos, dtype=np.float64)
    density = np.asarray(density, dtype=np.float64)
    if (pos.shape != ref_pos.shape or not np.isfinite(pos).all()
            or not np.isfinite(density).all()):
        return {"position_gap_max": math.inf, "position_gap_p99": math.inf,
                "density_gap_max": math.inf, "density_gap_p99": math.inf}
    d = np.linalg.norm(pos - ref_pos, axis=1)
    rel = np.abs(density - ref_density) / ref_density
    return {"position_gap_max": float(d.max()), "position_gap_p99": float(np.percentile(d, 99)),
            "density_gap_max": float(rel.max()), "density_gap_p99": float(np.percentile(rel, 99))}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}} of the compared numbers).
    Correct where limits exist and every compared number is within its own."""
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = bool(compared) and all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared


def worst(*numbers: dict[str, float]) -> dict[str, float]:
    """The larger reading of each number over several outputs."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}
