"""Density and force passes over cell-sorted particles.

Counterpart of the two kernels of `tpusph/pallas/fused.py`:
`density_pallas` and `force_pallas`. The CUDA kernels are in
`tpusph_torch/csrc/sph.cu`; `density_plain` and `force_plain` are the same
functions in plain PyTorch. `density` and `force` take the plain version
for CPU tensors and launch the kernels for CUDA tensors: `force` first
packs its eight fields into two float4 rows a particle (`force_pack`,
`force_pack_plain`), which the force kernel reads a candidate and a pair
at a time.

Both walk, for each sorted target with key k, its 9 stencil windows of
the sorted order: for column (dy, dz), off = dy·C + dz·C², the candidates
are rows starts[lo] .. starts[hi], lo = clip(k+off−1, 0, nc) and
hi = clip(k+off+2, lo, nc). These are exactly the pairs the JAX package's
key mask accepts, so no mask is needed. The JAX package's window prep
(`supertile_columns` and its TPU tables) has no counterpart: the kernels
read the starts table directly.

The kernels give a block of `DENSITY_TILE` consecutive targets its 9
windows at once. A density block whose targets are dense sweeps the union
of its windows, one ascending sweep per column, staged through shared
memory in chunks of at most `DENSITY_CHUNK` rows; `chunk_walk` is that
sweep in plain PyTorch. `density_baseline` launches the density's first
design (`csrc/sph_baseline.cu`, one thread per target gathering from
device memory), the reference the tiled density is held to bit for bit,
staged blocks included; the engine never calls it.

The plain versions vectorise that walk as a padded gather, [B, 9, W] per
chunk of B = cfg.chunk_size targets, W the largest window count (read
once on the host), so peak memory stays bounded at 262,144 particles.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusph_torch.core.config import SimConfig, f32
from tpusph_torch.kernels.launch import check_tensor, on_cpu, plain_version, stream_of

# The density kernel's shape (csrc/sph.cu kTile, kChunk, kStageMin,
# kPieces): blocks of 128 targets; stages of 1024 row slots in at most 16
# chunks; a block stages when its live targets average at least 96
# candidates, else it reads device memory, whose loads hit L1 (neighbouring
# targets share most of their windows). The fastest mean over steps 0, 20,
# 50 and 100 of 262,144 grid init on an H100 (PERF.md). The force
# kernel takes blocks of FORCE_TILE = 128 targets (the same kTile), never
# stages, and reads `force_pack`'s rows.
DENSITY_TILE, DENSITY_CHUNK, DENSITY_STAGE_MIN = 128, 1024, 96
PIECES = 16
FORCE_TILE = 128
# The force kernel's walk counter, int64[3] (`force(..., walk=)`): what it
# holds, in order. With the launch's blocks (`force_blocks`) these are the
# four numbers of a counted force pass.
WALK = ("candidates", "pressured", "block_max")


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


def pair_counts(x, y, z, key_sorted, starts, cfg: SimConfig) -> tuple[int, int, int]:
    """(candidates, pairs with r² ≤ h², pairs with r² ≤ h² and r ≥ EPS_F):
    the work of the density and the force pass on these inputs, counted
    with the plain versions' arithmetic."""
    h2, eps = f32(cfg.h2), f32(cfg.eps)
    cand = within = apart = 0
    for c0, c1, idx, live in _chunked_candidates(key_sorted, starts, cfg):
        ddx, ddy, ddz = (a[c0:c1, None, None] - a[idx] for a in (x, y, z))
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        near = live & (r2 <= h2)
        cand += int(live.sum())
        within += int(near.sum())
        apart += int((near & (torch.sqrt(r2) >= eps)).sum())
    return cand, within, apart


def staged_slots(start, stop):
    """Stage slots of the chunk [start, stop): the kernels copy 16 bytes,
    4 rows of a field, at a time, from start aligned down to 4 rows to stop
    aligned up."""
    return ((stop + 3) & ~3) - (start & ~3)


def chunk_walk(key_sorted, starts, cfg: SimConfig, tile: int = DENSITY_TILE,
               chunk: int = DENSITY_CHUNK, stage_min: int = 0) -> torch.Tensor:
    """The density kernel's sweep: int64[m, 5] rows (block, stage, column,
    start, stop), the chunks each block of `tile` targets stages, in the
    order it stages them; a block's stages count from 0 and hold at most `chunk`
    slots (`staged_slots`) in at most PIECES chunks.

    Per column (in `column_offsets` order), a block's first chunk starts at
    the smallest begin of its non-empty windows; each later one at the
    smallest max(begin, cursor) over the windows with rows past the cursor,
    the previous chunk's stop. A chunk stops where its slots fill its
    stage or at the block's last window end in the column, whichever comes
    first. Sentinel rows and rows past n have empty windows. A block whose
    live targets average fewer than `stage_min` candidates stages nothing."""
    n = key_sorted.shape[0]
    begin, count = windows(key_sorted, starts, cfg)
    begin, end = begin.cpu().numpy(), (begin + count).cpu().numpy()
    live_rows = (key_sorted < cfg.num_cells).cpu().numpy()
    out = []
    for blk in range(-(-n // tile)):
        b, e = begin[blk * tile:(blk + 1) * tile], end[blk * tile:(blk + 1) * tile]
        has = e > b
        live = int(live_rows[blk * tile:(blk + 1) * tile].sum())
        if not live or int((e - b).sum()) < live * stage_min:
            continue
        column, cursor, last = 0, -1, 0

        def next_chunk(room):
            nonlocal column, cursor, last
            while column < 9:
                bc, ec, hc = b[:, column], e[:, column], has[:, column]
                if cursor < 0:
                    if not hc.any():
                        column += 1
                        continue
                    start, last = int(bc[hc].min()), int(ec[hc].max())
                elif cursor >= last:
                    column, cursor = column + 1, -1
                    continue
                else:
                    frm = np.maximum(bc, cursor)
                    start = int(frm[ec > frm].min())
                cursor = min((start & ~3) + room, last)
                return column, start, cursor
            return None

        stage = 0
        while True:
            used = pieces = 0
            while pieces < PIECES and used < chunk:
                c = next_chunk(chunk - used)
                if c is None:
                    break
                out.append((blk, stage, *c))
                used += staged_slots(c[1], c[2])
                pieces += 1
            if not pieces:
                break
            stage += 1
    return torch.tensor(out, dtype=torch.int64).reshape(-1, 5)


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


def _launch_density(entry, x, y, z, key_sorted, starts, cfg: SimConfig):
    dev, n = _check_sorted_inputs(dict(x=x, y=y, z=z), key_sorted, starts, cfg)
    if on_cpu(dev):
        with plain_version():
            return density_plain(x, y, z, key_sorted, starts, cfg)
    from tpusph_torch.utils import cuda_build

    rho = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = getattr(cuda_build.library(), entry)(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), key_sorted.data_ptr(),
            starts.data_ptr(), n, cfg.num_cells_per_dim, cfg.num_cells,
            f32(cfg.h2), f32(f32(cfg.mass) * f32(cfg.d_kernel_coeff)),
            rho.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, entry)
    return rho


def density(x, y, z, key_sorted, starts, cfg: SimConfig):
    """Raw density of each sorted target (see `density_plain`). Launches
    `tpusph_density` for CUDA tensors: blocks of DENSITY_TILE targets, which
    stage their windows from DENSITY_STAGE_MIN candidates a target."""
    rho = _launch_density("tpusph_density", x, y, z, key_sorted, starts, cfg)
    if rho.is_cuda:
        density.launches += 1
    return rho


density.launches = 0


def density_baseline(x, y, z, key_sorted, starts, cfg: SimConfig):
    """`density` on the first design's kernel, `tpusph_density_baseline`:
    the same sums in the same order as `density`, so the same bits."""
    rho = _launch_density("tpusph_density_baseline", x, y, z, key_sorted, starts, cfg)
    if rho.is_cuda:
        density_baseline.launches += 1
    return rho


density_baseline.launches = 0


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


def force_blocks(n: int) -> int:
    """Blocks of FORCE_TILE targets the force kernel launches over n rows."""
    return -(-n // FORCE_TILE)


def force_walk(key_sorted, starts, p, cfg: SimConfig) -> torch.Tensor:
    """int64[3] of WALK: what the force kernel's walk counter takes over the
    sorted rows, from its windows alone: the candidates its targets walk
    (each live target's 9 window lengths), the live targets (key below
    num_cells) with p > 0, and the candidates of its heaviest block of
    FORCE_TILE consecutive targets."""
    n = key_sorted.shape[0]
    if n == 0:
        return torch.zeros(len(WALK), dtype=torch.int64, device=key_sorted.device)
    per_target = windows(key_sorted, starts, cfg)[1].sum(dim=1)
    pressured = ((key_sorted < cfg.num_cells) & (p > 0)).sum()
    blocks = force_blocks(n)
    per_block = torch.nn.functional.pad(per_target, (0, blocks * FORCE_TILE - n))
    block_max = per_block.view(blocks, FORCE_TILE).sum(dim=1).max()
    return torch.stack([per_target.sum(), pressured, block_max])


def force_pack_plain(x, y, z, vx, vy, vz, rho, p) -> tuple[torch.Tensor, torch.Tensor]:
    """The force kernel's packed rows in plain PyTorch, f32[n, 4] each:
    r0 = (x, y, z, 1/(2ρ)) and r1 = (vx, vy, vz, p), ρ the clamped density."""
    return (torch.stack([x, y, z, 1.0 / (2.0 * rho)], dim=1),
            torch.stack([vx, vy, vz, p], dim=1))


def force_pack(x, y, z, vx, vy, vz, rho, p) -> tuple[torch.Tensor, torch.Tensor]:
    """(r0, r1), the rows the force kernel reads (see `force_pack_plain`).
    Launches `tpusph_force_pack` for CUDA tensors, one thread a row, into two
    fresh (n, 4) arrays: the kernel reads a row as one float4. 1/(2ρ) is the
    correctly rounded quotient, as `force_pack_plain`'s."""
    fields = dict(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz, rho=rho, p=p)
    dev, n = x.device, x.shape[0]
    for name, t in fields.items():
        check_tensor(name, t, torch.float32, dev, (n,))
    if on_cpu(dev):
        with plain_version():
            return force_pack_plain(*fields.values())
    return _launch_pack(fields, n, dev)


def _launch_pack(fields: dict, n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """`tpusph_force_pack` on the checked CUDA fields. The caching allocator
    starts every block on a 16-byte boundary; the entry point refuses rows
    off one."""
    from tpusph_torch.utils import cuda_build

    r0, r1 = fields["x"].new_empty((n, 4)), fields["x"].new_empty((n, 4))
    with torch.cuda.device(dev):
        err = cuda_build.library().tpusph_force_pack(
            *(t.data_ptr() for t in fields.values()), n, r0.data_ptr(), r1.data_ptr(),
            stream_of(dev))
    cuda_build.check(err, "tpusph_force_pack")
    force_pack.launches += 1
    return r0, r1


force_pack.launches = 0


def force(x, y, z, vx, vy, vz, rho, p, key_sorted, starts, cfg: SimConfig,
          walk: torch.Tensor | None = None) -> torch.Tensor:
    """Force on each sorted target, f32[3, n] (see `force_plain`). For CUDA
    tensors, packs the rows (`force_pack`) and launches `tpusph_force` on
    them, both on the current stream: blocks of 128 targets reading device
    memory, a candidate as one 16-byte row (x, y, z, 1/(2ρ)) and a pair
    within h as one more (vx, vy, vz, p), so 1/(2ρ_j) is taken once a
    particle, not in three divides a pair; r from rsqrt rather than sqrt,
    a few ulps apart.

    `walk`: an int64[3] counter on the rows' device, zeroed by the caller,
    to which the pass adds its walk (WALK, `force_walk`): on a card the
    kernel's blocks count it beside their sums, on the CPU `force_walk`
    computes it. None counts nothing, and the forces are the same bits."""
    fields = dict(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz, rho=rho, p=p)
    dev, n = _check_sorted_inputs(fields, key_sorted, starts, cfg)
    if walk is not None:
        check_tensor("walk", walk, torch.int64, dev, (len(WALK),))
    if on_cpu(dev):
        with plain_version():
            f = force_plain(*fields.values(), key_sorted, starts, cfg)
            if walk is not None:
                got = force_walk(key_sorted, starts, p, cfg)
                walk[:2] += got[:2]
                walk[2:] = torch.maximum(walk[2:], got[2:])
        return f
    r0, r1 = _launch_pack(fields, n, dev)
    from tpusph_torch.utils import cuda_build

    f = r0.new_empty((3, n))
    with torch.cuda.device(dev):
        err = cuda_build.library().tpusph_force(
            r0.data_ptr(), r1.data_ptr(), key_sorted.data_ptr(), starts.data_ptr(), n,
            cfg.num_cells_per_dim, cfg.num_cells, f32(cfg.h), f32(cfg.h2), f32(cfg.eps),
            f32(cfg.mass), f32(cfg.v_kernel_coeff), f32(cfg.viscosity), f.data_ptr(),
            None if walk is None else walk.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "tpusph_force")
    force.launches += 1
    return f


force.launches = 0

