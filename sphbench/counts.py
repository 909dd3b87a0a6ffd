"""The work behind each roofline: bytes, operations and the least time.

The work is the physics', whatever kernel does it, so a kernel that is
fused or replaced is judged against the same yardstick:

- bytes: each input and output of the stage once a particle. The density
  reads the positions (12 B) and writes the raw density (4 B); the force
  reads positions, velocities and density (28 B) and writes the force
  (12 B).
- operations: a fixed count a pair within h, from the formulas of
  `reference/sph.py`, with the constant factors taken out of the sums
  (each a few operations a particle). A division and a square root count
  as one operation each.
- the least time: the larger of the bytes at the card's memory bandwidth
  and the operations at its float32 rate outside the tensor cores.

Pairs within h are ordered pairs (i, j): for the density r^2 <= h^2 with
the particle itself included, for the force also r >= EPS.
"""

from __future__ import annotations

# Published peaks (NVIDIA's H100 data sheet, SXM part, dense, at 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}

# density, a pair: x_i - x_j (3), r^2 (3 mul, 2 add), h^2 - r^2 (1),
# its cube (2), the sum (1)
DENSITY_FLOPS_PER_PAIR = 3 + 5 + 1 + 2 + 1
# a particle: the sum times mass * poly6 coefficient
DENSITY_FLOPS_PER_PARTICLE = 1
DENSITY_BYTES_PER_PARTICLE = 12 + 4

# force, a pair: x_i - x_j (3), r^2 (5), r (1), h - r (1), 1/rho_j (1),
# 1/r (1); pressure: p_i + p_j (1), times (h - r)^2 (2), times 1/rho_j
# (1), times 1/r (1), times the three components (3) and their sums (3);
# viscosity: (h - r) / rho_j (1), v_j - v_i (3), times it (3), the sums (3)
FORCE_FLOPS_PER_PAIR = 3 + 5 + 1 + 1 + 1 + 1 + (1 + 2 + 1 + 1 + 3 + 3) + (1 + 3 + 3 + 3)
# a particle: the pressure sum times -m * spiky / 2 and the viscosity sum
# times mu * m * laplacian coefficient (6), the two added (3)
FORCE_FLOPS_PER_PARTICLE = 6 + 3
FORCE_BYTES_PER_PARTICLE = 28 + 12

STAGES = {
    "density": (DENSITY_FLOPS_PER_PAIR, DENSITY_FLOPS_PER_PARTICLE, DENSITY_BYTES_PER_PARTICLE),
    "force": (FORCE_FLOPS_PER_PAIR, FORCE_FLOPS_PER_PARTICLE, FORCE_BYTES_PER_PARTICLE),
}


def least_time(stage: str, n: int, pairs: int, peaks: dict) -> tuple[float, str]:
    """(seconds, "bytes" or "operations", whichever binds) of one call of
    `stage` over `n` particles with `pairs` pairs within h."""
    per_pair, per_particle, bytes_per_particle = STAGES[stage]
    t_bytes = n * bytes_per_particle / peaks["bytes_per_s"]
    t_ops = (pairs * per_pair + n * per_particle) / peaks["flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def least_seconds(stage: str, n: int, pairs_per_step, runs: int, peaks: dict):
    """(seconds, {"bytes": calls, "operations": calls}) of `runs` runs whose
    steps have the pairs `pairs_per_step` ((density, force) a step)."""
    col = 0 if stage == "density" else 1
    total, binds = 0.0, {"bytes": 0, "operations": 0}
    for step_pairs in pairs_per_step:
        t, what = least_time(stage, n, step_pairs[col], peaks)
        total += t
        binds[what] += runs
    return total * runs, binds
