"""Density and force passes over cell-sorted particles.

Counterpart of the two kernels of `tpusph/pallas/fused.py`:
`density_pallas` and `force_pallas`. The CUDA kernels are in
`tpusph_torch/csrc/sph.cu`; `density_plain` and `force_plain` are the same
functions in plain PyTorch. `density` and `force` take the plain version
for CPU tensors and launch the kernel for CUDA tensors.

Both walk, for each sorted target with key k, its 9 stencil windows of
the sorted order: for column (dy, dz), off = dy·C + dz·C², the candidates
are rows starts[lo] .. starts[hi], lo = clip(k+off−1, 0, nc) and
hi = clip(k+off+2, lo, nc). These are exactly the pairs the JAX package's
key mask accepts, so no mask is needed. The JAX package's window prep
(`supertile_columns` and its TPU tables) has no counterpart: the kernels
read the starts table directly.

The plain versions vectorise that walk as a padded gather, [B, 9, W] per
chunk of B = cfg.chunk_size targets, W the largest window count (read
once on the host), so peak memory stays bounded at 262,144 particles.
"""

from __future__ import annotations

import torch

from tpusph_torch.core.config import SimConfig, f32
from tpusph_torch.kernels.launch import check_tensor, on_cpu, stream_of


def column_offsets(cfg: SimConfig) -> list[int]:
    """Flat-key offsets of the 9 (dy, dz) neighbour columns, dz outer."""
    c = cfg.num_cells_per_dim
    return [dy * c + dz * c * c for dz in (-1, 0, 1) for dy in (-1, 0, 1)]


def windows(key_sorted, starts, cfg: SimConfig):
    """(begin, count), int64[n, 9]: each sorted target's 9 candidate row
    ranges. Sentinel rows get empty windows."""
    nc = cfg.num_cells
    offs = torch.tensor(column_offsets(cfg), dtype=torch.int64, device=key_sorted.device)
    base = key_sorted.long()[:, None] + offs
    lo = (base - 1).clamp(0, nc)
    hi = torch.maximum((base + 2).clamp(max=nc), lo)
    s = starts.long()
    begin = s[lo]
    count = torch.where(key_sorted[:, None] < nc, s[hi] - begin, 0)
    return begin, count


def _chunked_candidates(key_sorted, starts, cfg: SimConfig):
    """Yield (c0, c1, idx, live) per chunk of targets: idx int64[B, 9, W]
    candidate rows (0 where not live), live bool[B, 9, W]."""
    n = key_sorted.shape[0]
    begin, count = windows(key_sorted, starts, cfg)
    width = int(count.max()) if n else 0
    lane = torch.arange(width, device=key_sorted.device)
    for c0 in range(0, n, cfg.chunk_size):
        c1 = min(n, c0 + cfg.chunk_size)
        live = lane < count[c0:c1, :, None]
        idx = torch.where(live, begin[c0:c1, :, None] + lane, 0)
        yield c0, c1, idx, live


def _check_sorted_inputs(fields, key_sorted, starts, cfg: SimConfig):
    dev = key_sorted.device
    n = key_sorted.shape[0]
    check_tensor("key_sorted", key_sorted, torch.int32, dev)
    check_tensor("starts", starts, torch.int32, dev, (cfg.num_cells + 2,))
    for name, t in fields.items():
        check_tensor(name, t, torch.float32, dev, (n,))
    return dev, n


# ------------------------------------------------------------------ density


def density_plain(x, y, z, key_sorted, starts, cfg: SimConfig) -> torch.Tensor:
    """Raw density m·d_coeff·Σ_j (h²−r²)³ over window candidates with
    r² ≤ h², the target included; 0 for sentinel rows. f32[n], before the
    EPS clamp of `pressure_from_density`."""
    h2 = f32(cfg.h2)
    acc = torch.empty_like(x)
    for c0, c1, idx, live in _chunked_candidates(key_sorted, starts, cfg):
        ddx = x[c0:c1, None, None] - x[idx]
        ddy = y[c0:c1, None, None] - y[idx]
        ddz = z[c0:c1, None, None] - z[idx]
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        d = h2 - r2
        acc[c0:c1] = torch.where(live & (r2 <= h2), d * d * d, 0.0).sum(dim=(1, 2))
    return f32(f32(cfg.mass) * f32(cfg.d_kernel_coeff)) * acc


def density(x, y, z, key_sorted, starts, cfg: SimConfig) -> torch.Tensor:
    """Raw density of each sorted target (see `density_plain`). Launches
    `tpusph_density` for CUDA tensors."""
    dev, n = _check_sorted_inputs(dict(x=x, y=y, z=z), key_sorted, starts, cfg)
    if on_cpu(dev):
        return density_plain(x, y, z, key_sorted, starts, cfg)
    from tpusph_torch.utils import cuda_build

    lib = cuda_build.library()
    rho = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.tpusph_density(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), key_sorted.data_ptr(),
            starts.data_ptr(), n, cfg.num_cells_per_dim, cfg.num_cells,
            f32(cfg.h2), f32(f32(cfg.mass) * f32(cfg.d_kernel_coeff)),
            rho.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "density")
    density.launches += 1
    return rho


density.launches = 0


# -------------------------------------------------------------------- force


def force_plain(
    x, y, z, vx, vy, vz, rho, p, key_sorted, starts, cfg: SimConfig
) -> torch.Tensor:
    """Pressure plus viscosity force on each sorted target, summed over its
    window candidates with `pair_force`'s arithmetic and guards (the self
    pair drops out at r ≥ EPS_F). `rho` is the clamped density. Returns
    f32[3, n] field-major; sentinel rows are 0."""
    h, h2, eps = f32(cfg.h), f32(cfg.h2), f32(cfg.eps)
    m, vk = f32(cfg.mass), f32(cfg.v_kernel_coeff)
    mu_m = f32(f32(cfg.viscosity) * m)
    out = x.new_empty((3, x.shape[0]))
    for c0, c1, idx, live in _chunked_candidates(key_sorted, starts, cfg):
        disp = [a[c0:c1, None, None] - a[idx] for a in (x, y, z)]
        r2 = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
        r = torch.sqrt(r2)
        live_p = live & (r2 <= h2) & (r >= eps)
        live_v = live & (r <= h) & (r >= eps)
        safe_r = torch.where(live_p, r, 1.0)
        hr = h - safe_r
        grad = (-vk) * (hr * hr) / safe_r
        rho_j = rho[idx]
        coef = (-m) * (p[c0:c1, None, None] + p[idx]) / (2.0 * rho_j)
        visc = mu_m * (vk * (h - r)) / rho_j
        for a, (d, v) in enumerate(zip(disp, (vx, vy, vz))):
            dv = v[idx] - v[c0:c1, None, None]
            fa = torch.where(live_p, coef * (d * grad), 0.0) + torch.where(
                live_v, visc * dv, 0.0
            )
            out[a, c0:c1] = fa.sum(dim=(1, 2))
    return out


def force(x, y, z, vx, vy, vz, rho, p, key_sorted, starts, cfg: SimConfig) -> torch.Tensor:
    """Force on each sorted target, f32[3, n] (see `force_plain`). Launches
    `tpusph_force` for CUDA tensors."""
    fields = dict(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz, rho=rho, p=p)
    dev, n = _check_sorted_inputs(fields, key_sorted, starts, cfg)
    if on_cpu(dev):
        return force_plain(x, y, z, vx, vy, vz, rho, p, key_sorted, starts, cfg)
    from tpusph_torch.utils import cuda_build

    lib = cuda_build.library()
    f = x.new_empty((3, n))
    with torch.cuda.device(dev):
        err = lib.tpusph_force(
            *(t.data_ptr() for t in fields.values()),
            key_sorted.data_ptr(), starts.data_ptr(), n, cfg.num_cells_per_dim,
            cfg.num_cells, f32(cfg.h), f32(cfg.h2), f32(cfg.eps), f32(cfg.mass),
            f32(cfg.v_kernel_coeff), f32(cfg.viscosity), f.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "force")
    force.launches += 1
    return f


force.launches = 0
