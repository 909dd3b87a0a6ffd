"""The plain reference: the CUDA original's timestep in plain PyTorch.

andrew-sha/CUDAFluidSimulator, `src/simulator.cu`: kernelBuildGrid
(cell = (int)(x / h) per axis), kernelUpdatePressureAndDensity (poly6
over the 27-cell stencil, self included; rho = max(rho, EPS), p = max(0,
k(rho - rho0))), kernelUpdateForces (pressure by the spiky gradient,
viscosity by its Laplacian, both over EPS <= r <= h) and
kernelUpdatePositions (v += dt (f / rho + g), x += dt v, per-axis clamp
to [h, box - h] with v *= -elasticity on a clamped axis, then |v_c| < EPS
-> 0). The constants are the configuration file's, rounded to the run's
precision as the original's float literals are (`PI` 3.14159265).

Independent of the port: it imports nothing of `tpusph_torch` and takes
nothing the port made. Pairs are listed explicitly (every candidate of
the 27 neighbouring cells, one flat row each) in blocks of at most
`block_pairs`, and each target's terms are summed by `segment_reduce`
in a fixed order, so two runs give the same bits. `dtype` is the
precision of every tensor and operation: float32 for the reference,
bfloat16 for its control.
"""

from __future__ import annotations

import torch

OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


class Constants:
    """The step's constants for `config` in `dtype`, as Python floats that
    a tensor of `dtype` rounds once."""

    def __init__(self, config: dict, dtype: torch.dtype):
        def r(x):  # round through dtype
            return torch.tensor(x, dtype=dtype).item()

        self.dtype = dtype
        self.h = r(config["h"])
        self.h2 = r(self.h * self.h)
        self.cells = int(config["num_cells_per_dim"])
        self.dt = r(config["dt"])
        self.mass = r(config["mass"])
        self.k = r(config["gas_constant"])
        self.rho0 = r(config["rest_density"])
        self.mu = r(config["viscosity"])
        self.g = r(config["gravity"])
        self.e = r(config["elasticity"])
        self.eps = r(config["eps"])
        pi, h = config["pi"], config["h"]
        self.vk = r(45.0 / (pi * h**6))  # spiky gradient and viscosity Laplacian
        self.dk = r(315.0 / (64.0 * pi * h**9))  # poly6
        self.lo = self.h
        self.hi = r(r(config["box_dim"]) - self.h)


def run(position: torch.Tensor, config: dict, steps: int, dtype=torch.float32,
        block_pairs: int = 1 << 24, velocity: torch.Tensor | None = None) -> dict:
    """`steps` steps from `position` with `velocity` (at rest where None). Returns position and velocity
    (f32[N, 3]), the last step's density (f32[N]), and a list of (pairs
    within h of the density, pairs of the force) for each step: ordered
    pairs (i, j) with r^2 <= h^2, self included, and those with also
    r >= EPS."""
    c = Constants(config, dtype)
    pos = position.to(dtype)
    vel = torch.zeros_like(pos) if velocity is None else velocity.to(dtype)
    pairs = []
    rho = None
    for _ in range(steps):
        pos, vel, rho, counted = step(pos, vel, c, block_pairs)
        pairs.append(counted)
    pairs = [(int(a), int(b)) for a, b in pairs]
    return {"position": pos.float(), "velocity": vel.float(), "density": rho.float(),
            "pairs": pairs}


def step(pos, vel, c: Constants, block_pairs: int):
    """One timestep; returns (position, velocity, density, (density pairs,
    force pairs) as 0-d tensors)."""
    n = pos.shape[0]
    C = c.cells
    cell = (pos.float() / torch.tensor(c.h, dtype=torch.float32, device=pos.device))
    cell = cell.to(torch.int32).clamp(0, C - 1).long()
    key = cell[:, 0] + C * cell[:, 1] + C * C * cell[:, 2]
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=C**3)
    starts = torch.cumsum(counts, 0) - counts
    seg_start = torch.empty((n, 27), dtype=torch.long, device=pos.device)
    seg_len = torch.empty((n, 27), dtype=torch.long, device=pos.device)
    for o, off in enumerate(OFFSETS):
        nb = cell + torch.tensor(off, device=pos.device)
        inside = ((nb >= 0) & (nb < C)).all(dim=1)
        nk = (nb[:, 0] + C * nb[:, 1] + C * C * nb[:, 2]).clamp(0, C**3 - 1)
        seg_start[:, o] = starts[nk]
        seg_len[:, o] = torch.where(inside, counts[nk], 0)
    per_target = seg_len.sum(dim=1)
    blocks = _blocks(per_target, block_pairs)

    def pairs_of(a, b):
        sl, ss = seg_len[a:b].reshape(-1), seg_start[a:b].reshape(-1)
        seg = torch.repeat_interleave(torch.arange(sl.numel(), device=pos.device), sl)
        first = torch.cumsum(sl, 0) - sl
        local = torch.arange(seg.numel(), device=pos.device) - first[seg]
        return a + seg // 27, order[ss[seg] + local], per_target[a:b]

    rho = torch.empty(n, dtype=pos.dtype, device=pos.device)
    n_density = torch.zeros((), dtype=torch.long, device=pos.device)
    for a, b in blocks:
        i, j, lengths = pairs_of(a, b)
        d = pos[i] - pos[j]
        r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        near = r2 <= c.h2
        w = c.h2 - r2
        term = torch.where(near, c.mass * (c.dk * (w * w * w)), 0.0)
        rho[a:b] = _segment_sum(term, lengths)
        n_density += near.sum()
    rho = torch.clamp(rho, min=c.eps)
    p = torch.clamp(c.k * (rho - c.rho0), min=0.0)

    f = torch.empty_like(pos)
    n_force = torch.zeros((), dtype=torch.long, device=pos.device)
    for a, b in blocks:
        i, j, lengths = pairs_of(a, b)
        d = pos[i] - pos[j]
        r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        r = torch.sqrt(r2)
        live_p = (r2 <= c.h2) & (r >= c.eps)
        safe_r = torch.where(live_p, r, 1.0)
        hr = c.h - safe_r
        spiky = torch.where(live_p, (-c.vk) * (hr * hr) / safe_r, 0.0)
        rho_j = rho[j]
        coef_p = (-c.mass) * (p[i] + p[j]) / (2.0 * rho_j)
        live_v = (r <= c.h) & (r >= c.eps)
        lap = torch.where(live_v, c.vk * (c.h - r), 0.0)
        coef_v = c.mu * c.mass * lap / rho_j
        dv = vel[j] - vel[i]
        terms = (coef_p * spiky)[:, None] * d + coef_v[:, None] * dv
        f[a:b] = torch.stack([_segment_sum(terms[:, ax].contiguous(), lengths)
                              for ax in range(3)], dim=1)
        n_force += live_p.sum()

    gravity = torch.tensor([0.0, c.g, 0.0], dtype=pos.dtype, device=pos.device)
    vel = vel + c.dt * (f / rho[:, None] + gravity)
    pos = pos + c.dt * vel
    out = (pos < c.lo) | (pos > c.hi)
    pos = torch.clamp(pos, c.lo, c.hi)
    vel = torch.where(out, vel * (-c.e), vel)
    vel = torch.where(torch.abs(vel) < c.eps, 0.0, vel)
    return pos, vel, rho, (n_density, n_force)


def _blocks(per_target: torch.Tensor, block_pairs: int) -> list[tuple[int, int]]:
    """Consecutive target ranges with at most `block_pairs` candidate pairs
    each (at least one target)."""
    cum = torch.cumsum(per_target, 0).cpu()
    n = cum.numel()
    out, a, done = [], 0, 0
    while a < n:
        b = int(torch.searchsorted(cum, done + block_pairs, right=True))
        b = max(b, a + 1)
        out.append((a, b))
        done = int(cum[b - 1])
        a = b
    return out


def _segment_sum(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(x, "sum", lengths=lengths)
