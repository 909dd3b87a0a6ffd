"""Spatial domain sharding: SPH past one card. Counterpart of
`tpusph/dist/sharded.py`, function for function.

The 10×10×10 box is split into z-slabs along a line of ranks. The JAX
package holds one global array a field, sharded on a 1-D mesh, and runs
one per-device function under `shard_map`. Here every rank is a process
(`torch.distributed`, SPMD) that holds its own slab's fixed-capacity
padded tensors, a `DistState` of `dev_capacity` rows, and calls the same
per-device functions directly; `dist/comm.py::SlabComm` stands where the
mesh collectives stood. Per step and rank:

  1. **Local cell-key sort first.** One stable sort of the keys carries
     the six field rows and a pid / ownership tag. The flat key is z-major
     (x + C·y + C²·z), so the 2h boundary bands are contiguous in sorted
     order: the dn-send set is a prefix (keys below a cell-plane
     threshold) and the up-send set a suffix ending at n_valid, and the
     halo send buffers are slices of the sorted rows.
  2. **Halo exchange.** The two 2h face layers (position, velocity,
     valid) go to the adjacent ranks. The ghost layer is two smoothing
     radii deep, so every halo copy within h of the face sees all of its
     own neighbours locally and its density is exact; deeper halo rows
     get wrong densities that nothing reads (force targets are local rows,
     their sources lie within h of the face). Needs slabs ≥ 2h wide.
  3. **Combined sorted rows.** Where the slab faces lie on cell planes
     (C % D == 0, or explicit `slab_planes`) the lo-halo, local and hi-halo
     key ranges are disjoint, and the combined rows are spliced: a small
     sort of the 2·halo_capacity received rows and three fixed-size
     writes. Other rank counts take a full-width merge sort.
  4. **Physics.** The rank, density and force kernels run on the combined
     `dev_capacity + 2·halo_capacity` rows of each rank (backend
     `kernels`), or the plain-torch tile passes (`cell_list`).
  5. **Integration and click impulse**, live local rows only.
  6. **Migration and compaction, one sort.** Rows are category-sorted
     dn-migrants < kept < up-migrants < dead, so one stable sort yields
     both direction buffers and the kept-first compacted state; arrivals
     scatter into the free tail. On a rank without slab-crossers in a
     spliced layout (step 3) the sort is skipped, as the JAX package
     skips it with a `lax.cond`: there the live rows are one contiguous
     block behind the n_lo lo-halo rows, and the stable sort of a
     category that is "kept" on that block and "dead" everywhere else
     moves the block to the front and the n_lo rows behind it, a
     rotation of the first n_lo + n_kept rows that `_skip_order` gives
     without sorting, bit for bit every row the sort gives. The
     exchange still sends its fixed-size buffers, their lanes masked.
     The eager step (`.eager`) has no device-side branch, so the
     choice is a host read of whether this rank has crossers, one
     wait a step, just before the migration exchange (which on a
     host-staged group waits on the card anyway). A graphed step
     reads nothing: it branches on the device as tpusph's `lax.cond`
     does (`_graphed_order`): the rotation is computed every step, and a
     conditional node (`graphs.device_if`) runs the category sort only
     where a row crosses. `migration_sorts` and `migration_skips`
     count the branches taken; a graph's count stays on the card until
     `migration_counts()` reads it. TPUSPH_DIST_FORCE_MIGSORT=1 turns the
     skip off. On a line of one rank migration cannot happen and the
     phase is elided, unless TPUSPH_DIST_FULL_MACHINERY=1.

All buffers have fixed capacity with overflow detection, never a silent
drop: an overflowing step returns wrong rows and counters that say so.
Offsets that depend on the data (`n_valid`, `n_lo`, `n_dn`, ...) stay 0-d
tensors on the device: a dynamic slice is a gather at `offset + arange`
and a dynamic update a write at the same index, the start clamped so the
window fits as `lax.dynamic_slice` clamps it. An eager step therefore
waits on the card nowhere but in the exchange of a host-staged group, in
the skip's decision (§6) and where the caller reads the counters.

Dispatches: tpusph jits each step, timed phase and production chain as
one dispatch, its collectives inside. Here each is CUDA-graph replays on
a card (`RankGraphs`, `engine/graphs.py::SegmentedLoop`), its body run
under the capture guard on the CPU. On a line of one rank (`comm.size ==
1`) that is one replay. A rank with peers replays segments between the
transports, which cannot sit in a graph (a gloo exchange is a copy to the
host, a send and a receive, a copy back): a step is three segments, split
at the halo exchange and the migration exchange and ending at the reduce
of the counters. An NCCL group takes the same segments; a graph with its
collectives inside needs one card a rank.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch.bench.spans import span
from tpusph_torch.core.config import SimConfig
from tpusph_torch.dist.comm import SlabComm, int32s
from tpusph_torch.engine.graphs import SegmentedLoop, device_if
from tpusph_torch.engine.step import (
    _density_pass_sorted,
    _force_pass_sorted,
    resolve_backend,
)
from tpusph_torch.interact.impulse import click_cell_from_px, click_kick_fields
from tpusph_torch.kernels.fused import density, force
from tpusph_torch.neighbors.cell_list import starts_from_sorted, starts_table
from tpusph_torch.neighbors.grid import compute_keys_fields, h_tensor
from tpusph_torch.physics.integrate import integrate_fields
from tpusph_torch.physics.kernels import pressure_from_density


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Static capacities of the sharded engine, all per rank."""

    n_devices: int
    dev_capacity: int  # particle slots a rank
    halo_capacity: int  # halo buffer rows a direction (the 2h layer)
    migration_capacity: int  # migration buffer rows a direction
    # Optional balance-aware partition: n_devices + 1 ascending z
    # cell-plane indices (0 .. C); rank d owns the cells [planes[d],
    # planes[d+1]). None = equal-width slabs. Cell-plane edges make every
    # rank count take the splice path. `balanced_slab_planes` computes them.
    slab_planes: tuple | None = None

    def validate(self) -> None:
        # the JAX package's rule, kept so that configurations carry over
        for f in ("dev_capacity", "halo_capacity", "migration_capacity"):
            v = getattr(self, f)
            if v <= 0 or v % 8:
                raise ValueError(f"{f} must be a positive multiple of 8, got {v}")


def _check_slab_width(cfg: SimConfig, dcfg: DistConfig) -> None:
    """The 2h ghost layer needs slabs at least 2h wide. With explicit slab
    planes that is a gap of ≥ 2 cells (a cell edge is h), besides the
    shape and monotonicity of the planes."""
    if dcfg.slab_planes is not None:
        pl = tuple(int(p) for p in dcfg.slab_planes)
        C, D = cfg.num_cells_per_dim, dcfg.n_devices
        if len(pl) != D + 1 or pl[0] != 0 or pl[-1] != C:
            raise ValueError(
                f"slab_planes must be {D + 1} cell planes spanning [0, {C}], got {pl}"
            )
        gaps = [b - a for a, b in zip(pl, pl[1:])]
        if min(gaps) < 2:
            raise ValueError(
                f"slab_planes gaps {gaps}: every slab needs ≥ 2 cells (2h ghost layer)"
            )
        return
    if cfg.box_dim / dcfg.n_devices < 2 * cfg.h:
        raise ValueError(
            f"slab width {cfg.box_dim / dcfg.n_devices:.4f} < 2h = "
            f"{2 * cfg.h:.4f}: at most "
            f"{int(cfg.box_dim // (2 * cfg.h))} z-slab ranks for this scene"
        )


class DistState(NamedTuple):
    """One rank's block of the particle state, `dev_capacity` rows; `pid`
    keeps a particle's global identity across migrations."""

    position: torch.Tensor  # f32[c_dev, 3]
    velocity: torch.Tensor  # f32[c_dev, 3]
    valid: torch.Tensor  # bool[c_dev]
    pid: torch.Tensor  # int32[c_dev]


class DistAux(NamedTuple):
    """A step's counters after the reduction over the ranks: 0-d int32
    tensors (on the host for a host-staged group, else on the device)."""

    halo_overflow: torch.Tensor
    migration_overflow: torch.Tensor
    window_overflow: torch.Tensor
    oob_count: torch.Tensor
    misrouted: torch.Tensor
    num_particles: torch.Tensor  # global census (conservation check)
    # utilisation (max over the ranks; max over a chain of steps), what a
    # driver needs to shrink slack-sized capacities to what a run uses
    max_dev_particles: torch.Tensor  # peak occupancy of a rank
    max_halo_send: torch.Tensor  # peak halo rows a direction
    max_migration_send: torch.Tensor  # peak migration rows a direction


# the branches of the migration step (module docstring §6) a process has
# taken since these were last set to 0: category sorts and skips
migration_sorts = 0
migration_skips = 0


# ----------------------------------------------- dynamic slices as gathers


@functools.cache
def _lane(n: int, device: torch.device) -> torch.Tensor:
    """int64 0 .. n−1 on `device`, one tensor per (n, device); read only."""
    return torch.arange(n, device=device)


def _take(r: torch.Tensor, start, length: int) -> torch.Tensor:
    """`lax.dynamic_slice` along the last axis: `length` entries of `r`
    from the 0-d tensor `start`, clamped so that the window fits."""
    start = start.clamp(0, r.shape[-1] - length)
    return r.index_select(-1, start + _lane(length, r.device))


def _put(out: torch.Tensor, val: torch.Tensor, start) -> torch.Tensor:
    """`lax.dynamic_update_slice` along the last axis, in place on `out`
    (a tensor this module has just made), the start clamped likewise."""
    start = start.clamp(0, out.shape[-1] - val.shape[-1])
    return out.index_copy_(-1, start + _lane(val.shape[-1], out.device), val)


def _compact(mask: torch.Tensor, fields: tuple, cap: int):
    """Pack the rows where mask is True into the first `cap` rows, stably.
    Returns (packed_fields, packed_valid, take_indices, overflow)."""
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    take = order[:cap]
    packed = tuple(f[take] for f in fields)
    overflow = (mask.sum() - cap).clamp(min=0)
    return packed, mask[take], take, overflow


def _compute_sorted_fields(key_s, sx, sy, sz, svx, svy, svz, cfg: SimConfig, backend: str):
    """Density and force over cell-sorted rows, the single-card hot path
    on one rank's combined rows. `kernels`: the starts from the rank
    kernel, then the density and force kernels (their plain versions for
    CPU tensors). `cell_list`: the histogram starts and the tile passes.
    Returns (rho_s, p_s, (fx, fy, fz), valid_s, window_overflow)."""
    valid_s = key_s < cfg.num_cells
    if backend == "kernels":
        starts, s_ovf = starts_from_sorted(key_s, cfg)
        raw = density(sx, sy, sz, key_s, starts, cfg)
        rho_s, p_s = pressure_from_density(raw, cfg)
        rho_s = torch.where(valid_s, rho_s, 1.0)
        p_s = torch.where(valid_s, p_s, 0.0)
        f_rows = force(sx, sy, sz, svx, svy, svz, rho_s, p_s, key_s, starts, cfg)
        fx, fy, fz = (torch.where(valid_s, f_rows[a], 0.0) for a in range(3))
        ovf_w = s_ovf
    else:
        starts = starts_table(key_s, cfg)
        sp = torch.stack([sx, sy, sz], dim=1)
        sv = torch.stack([svx, svy, svz], dim=1)
        rho_s, p_s, ovf_w = _density_pass_sorted(sp, key_s, valid_s, starts, cfg)
        f_s = _force_pass_sorted(sp, sv, rho_s, p_s, key_s, valid_s, starts, cfg)
        fx, fy, fz = f_s[:, 0], f_s[:, 1], f_s[:, 2]
    return rho_s, p_s, (fx, fy, fz), valid_s, ovf_w


def _slab_geometry(cfg: SimConfig, dcfg: DistConfig, comm: SlabComm):
    """(z_lo, z_hi, slab_w) of this rank's slab as float32 values. With
    explicit slab planes the bounds are plane·h and only informative: the
    migration predicates then run in cell space."""
    F = np.float32
    d = comm.rank
    if dcfg.slab_planes is not None:
        z_lo = F(dcfg.slab_planes[d]) * F(cfg.h)
        z_hi = F(dcfg.slab_planes[d + 1]) * F(cfg.h)
        return z_lo, z_hi, F(z_hi - z_lo)
    slab_w = F(cfg.box_dim) / F(dcfg.n_devices)
    z_lo = F(d) * slab_w
    return z_lo, F(z_lo + slab_w), slab_w


def _force_migsort() -> bool:
    """TPUSPH_DIST_FORCE_MIGSORT=1 switches the migration-free sort skip
    off (module docstring §6): every step of a multi-rank line then takes
    the category sort, as the JAX package's variable does there. Read at
    every step."""
    return os.environ.get("TPUSPH_DIST_FORCE_MIGSORT") == "1"


def _elide_single(dcfg: DistConfig) -> bool:
    """A line of one rank has no slab faces: halo and migration are absent
    and normally elided. TPUSPH_DIST_FULL_MACHINERY=1 keeps the whole
    multi-rank code path (dead halo buffers, the migration sort) so that
    one card can run and price what a middle rank of a real line pays,
    less the exchange itself."""
    return dcfg.n_devices == 1 and os.environ.get("TPUSPH_DIST_FULL_MACHINERY") != "1"


def _aligned(cfg: SimConfig, dcfg: DistConfig) -> bool:
    """Static: the slab faces lie on cell planes, so the lo-halo, local and
    hi-halo key ranges are disjoint and the combined rows can be spliced
    and need no second sort. True for explicit slab planes (any rank
    count) or where C % D == 0. The splice also needs c_dev ≥ 2·h_cap so
    that the local write covers the halo scratch."""
    return (
        dcfg.slab_planes is not None or cfg.num_cells_per_dim % dcfg.n_devices == 0
    ) and dcfg.dev_capacity >= 2 * dcfg.halo_capacity


def _plane_array(cfg: SimConfig, dcfg: DistConfig) -> tuple:
    """The D + 1 z cell-plane slab edges as ints; meaningful only where
    the partition is cell-aligned."""
    if dcfg.slab_planes is not None:
        return tuple(int(p) for p in dcfg.slab_planes)
    C, D = cfg.num_cells_per_dim, dcfg.n_devices
    return tuple(d * (C // D) for d in range(D + 1))


def _band_thresholds(cfg: SimConfig, dcfg: DistConfig, comm: SlabComm):
    """Key thresholds of the 2h send bands, in integer arithmetic from the
    rank: dn band = key < k_dn, up band = key ≥ k_up. Supersets of the
    float bands (z < z_lo + 2h, z ≥ z_hi − 2h), exact where the slabs are
    cell-aligned. The key is z-major, so both select contiguous runs of
    the key-sorted rows."""
    C, D, d = cfg.num_cells_per_dim, dcfg.n_devices, comm.rank
    if dcfg.slab_planes is not None:
        pl = _plane_array(cfg, dcfg)
        thr_dn, thr_up = pl[d] + 2, pl[d + 1] - 2
    else:
        thr_dn = (d * C + D - 1) // D + 2  # ceil(d·C/D) + 2
        thr_up = ((d + 1) * C) // D - 2  # floor((d+1)·C/D) − 2
    return thr_dn * C * C, thr_up * C * C


def _migration_predicates(nz, live, cfg: SimConfig, dcfg: DistConfig, comm: SlabComm):
    """(mig_dn, mig_up, misrouted_mask) for the z after integration. With
    explicit slab planes ownership is decided in cell space, by the float32
    division and truncation that the next build's keys use
    (`grid.cell_coords`), so that migration, `distribute_state` and the
    splice can never disagree at a slab face. Equal-width slabs compare
    floats, their faces not being representable."""
    if dcfg.slab_planes is not None:
        C, D, d = cfg.num_cells_per_dim, dcfg.n_devices, comm.rank
        pl = _plane_array(cfg, dcfg)
        zc = (nz / h_tensor(cfg, nz.device)).to(torch.int32).clamp(0, C - 1)
        mig_dn = live & (zc < pl[d])
        mig_up = live & (zc >= pl[d + 1])
        # one hop at most: beyond the adjacent slab is misrouted
        far_lo, far_hi = pl[max(d - 1, 0)], pl[min(d + 2, D)]
        return mig_dn, mig_up, live & ((zc < far_lo) | (zc >= far_hi))
    z_lo, z_hi, slab_w = _slab_geometry(cfg, dcfg, comm)
    mig_dn = live & (nz < float(z_lo))
    mig_up = live & (nz >= float(z_hi))
    mis = live & ((nz < float(z_lo - slab_w)) | (nz >= float(z_hi + slab_w)))
    return mig_dn, mig_up, mis


def _device_build(pos, vel, valid, pid, cfg: SimConfig, dcfg: DistConfig, comm: SlabComm):
    """Phase 1 on one rank's slab: local cell-key sort, exchange of the 2h
    halo slices, assembly of the combined rows; the sharded "grid
    construction" phase. Returns the sorted combined rows (key_s, sx, sy,
    sz, svx, svy, svz, tag_s) and this rank's (halo_overflow, oob_count,
    max_halo_send), not yet reduced."""
    c_dev, h_cap = dcfg.dev_capacity, dcfg.halo_capacity
    dev = pos.device

    # Stale and invalid slots park at the origin: only the gap to any
    # clamped valid position makes sentinel-keyed rows physically inert.
    rows = torch.cat([torch.where(valid[:, None], pos, 0.0), vel], dim=1).T  # [6, c_dev]
    # the ownership tag travels with the sort: a local valid row carries
    # its pid (≥ 0), a local invalid slot −1, a halo copy −2
    tag = torch.where(valid, pid, -1)
    key, oob_count = compute_keys_fields(rows[0], rows[1], rows[2], valid, cfg)
    key_l, perm = torch.sort(key, stable=True)
    lrows = rows.index_select(1, perm)
    ltag = tag.index_select(0, perm)
    if _elide_single(dcfg):
        # no slab faces, no halo layer: the combined rows are the local ones
        return (key_l, *lrows, ltag, 0, oob_count, 0)

    # ---- halo send windows, slices of the key-sorted rows. dn band: the
    # prefix of length n_dn. up band: the last n_up valid rows, sent as the
    # h_cap window that ends at n_valid, front-padded so that the slice
    # never clamps; lanes outside the band arrive masked invalid.
    k_dn, k_up = _band_thresholds(cfg, dcfg, comm)
    n_valid = valid.sum()
    n_dn = (key_l < k_dn).sum()
    n_up = ((key_l >= k_up) & (key_l < cfg.num_cells)).sum()
    halo_ovf = (n_dn - h_cap).clamp(min=0) + (n_up - h_cap).clamp(min=0)
    lane = _lane(h_cap, dev)
    dn6 = lrows[:, :h_cap]
    dn_valid = lane < torch.minimum(n_dn, n_valid)
    up6 = _take(torch.cat([lrows.new_zeros((6, h_cap)), lrows], dim=1), n_valid, h_cap)
    up_valid = lane >= (h_cap - n_up)

    # ---- the one exchange of the 2h ghost layer
    (lo6, lo_valid), (hi6, hi_valid) = comm.exchange([up6, up_valid], [dn6, dn_valid])

    # ---- received halo rows: park the invalid lanes, compute their keys
    h_valid = torch.cat([lo_valid, hi_valid])
    hrows = torch.where(h_valid, torch.cat([lo6, hi6], dim=1), 0.0)  # [6, 2·h_cap]
    hkey, _ = compute_keys_fields(hrows[0], hrows[1], hrows[2], h_valid, cfg)
    htag = ltag.new_full((2 * h_cap,), -2)

    if _aligned(cfg, dcfg):
        # ---- splice: live rows are inside their slab at build time, so
        # the lo, local and hi key ranges are disjoint: sort just the
        # 2·h_cap halo rows, then splice [lo_real | local | hi_real + dead
        # | dead] with three fixed-size writes.
        hk_s, hperm = torch.sort(hkey, stable=True)
        hrows_s = hrows.index_select(1, hperm)
        n_lo = lo_valid.sum()

        def splice(h_lane, local_lane, dead_val):
            dead = h_lane.new_full((*h_lane.shape[:-1], c_dev), dead_val)
            out = _put(torch.cat([h_lane, dead], dim=-1), local_lane, n_lo)
            return _put(out, _take(h_lane, n_lo, h_cap), n_lo + n_valid)

        key_s = splice(hk_s, key_l, cfg.num_cells)
        srows = splice(hrows_s, lrows, 0.0)
        tag_s = splice(htag, ltag, -2)
    else:
        # ---- general assembly: full-width merge sort of local ∪ halo
        key_s, cperm = torch.sort(torch.cat([key_l, hkey]), stable=True)
        srows = torch.cat([lrows, hrows], dim=1).index_select(1, cperm)
        tag_s = torch.cat([ltag, htag]).index_select(0, cperm)
    return (key_s, *srows, tag_s, halo_ovf, oob_count, torch.maximum(n_dn, n_up))


def _device_update(
    key_s, sx, sy, sz, svx, svy, svz, tag_s, click_cell, click_active,
    cfg: SimConfig, dcfg: DistConfig, comm: SlabComm, backend: str,
    with_click: bool = True, tally: list | None = None,
):
    """Phase 2 on one rank's slab: density and force, integration, click
    impulse, migration and repacking; the sharded "SPH update" phase.
    Takes `_device_build`'s sorted rows; returns (x, v, valid_new, pid_new,
    (window_ovf, migration_ovf, misrouted, n_valid, max_mig_send)), the
    counters not yet reduced. `tally` None: the migration branch is
    decided by a host read (`_skip_order`) and counted in
    `migration_sorts` / `migration_skips`; a list (a graphed body): decided
    on the device (`_graphed_order`), its int32[2] (sorts, skips)
    appended."""
    c_dev, m_cap = dcfg.dev_capacity, dcfg.migration_capacity
    dev = key_s.device

    # ---- density + forces; halo densities within h of the face are exact
    # thanks to the 2h layer, so there is no second exchange
    rho_s, _p_s, (fx, fy, fz), _valid_s, ovf_w = _compute_sorted_fields(
        key_s, sx, sy, sz, svx, svy, svz, cfg, backend
    )

    # ---- integrate live local rows; freeze halo copies and padding
    live = tag_s >= 0
    moved = integrate_fields(sx, sy, sz, svx, svy, svz, fx, fy, fz, rho_s, cfg)
    nx, ny, nz, nvx, nvy, nvz = (
        torch.where(live, a, b) for a, b in zip(moved, (sx, sy, sz, svx, svy, svz))
    )

    # ---- click impulse: after integration, from the pre-step cells, like
    # the single-card engine; before migration, so that a kicked
    # slab-crosser carries its kick to the new owner
    if with_click:
        kx, ky, kz = click_kick_fields(sx, sy, sz, live, click_cell, cfg)
        ca = torch.as_tensor(click_active, device=dev).to(torch.float32)
        nvx, nvy, nvz = nvx + kx * ca, nvy + ky * ca, nvz + kz * ca

    if _elide_single(dcfg):
        # the integrate clamp keeps every position inside [h, box − h], in
        # the only slab, so nothing migrates, and the live rows are already
        # the sorted prefix (the build sort puts sentinel keys last)
        x = torch.stack([nx, ny, nz], dim=1)
        v = torch.stack([nvx, nvy, nvz], dim=1)
        return x, v, live, torch.where(live, tag_s, -1), (ovf_w, 0, 0, live.sum(), 0)

    # ---- migration of slab-crossers (one hop) and kept-first repacking;
    # without crossers on a spliced layout the category sort is skipped
    global migration_sorts, migration_skips
    mig_dn, mig_up, mis_mask = _migration_predicates(nz, live, cfg, dcfg, comm)
    nrows = torch.stack([nx, ny, nz, nvx, nvy, nvz])
    skip = _aligned(cfg, dcfg) and not _force_migsort()
    if tally is not None:
        order, branch = _graphed_order(live, mig_dn, mig_up, m_cap, skip)
        tally.append(branch)
    else:
        order = _skip_order(live, mig_dn, mig_up, nrows.shape[1] + m_cap) if skip else None
        if order is None:
            migration_sorts += 1
        else:
            migration_skips += 1
    x, v, valid_new, pid_new, ovf_mig, mig_send = _final_hop(
        nrows, tag_s, live, mig_dn, mig_up, c_dev, m_cap, comm, order
    )
    return x, v, valid_new, pid_new, (ovf_w, ovf_mig, mis_mask.sum(), valid_new.sum(), mig_send)


def _skip_order(live, mig_dn, mig_up, length: int):
    """The migration-free sort skip (module docstring §6): None where this
    rank has slab-crossers, else the order of `length` rows that the
    category sort of `_final_hop` yields. In the spliced layout the live
    rows are the block [n_lo, n_lo + n_kept) behind the lo-halo rows;
    with every live row kept and every other row dead, the stable sort
    puts that block first and the rows before it next, the rest in
    place: the first n_lo + n_kept rows rotated by n_lo. The step's one
    read of the card takes the crossers, n_lo and n_kept together, so the
    order is one copy of three slices. The JAX package's skip slices
    c_dev rows from n_lo, which gives the same kept block but the hi-halo
    rows behind it where the sort puts the lo-halo rows; those slots are
    not valid, so only their contents differ."""
    first_live = live.to(torch.int32).argmax()  # n_lo; 0 where no row is live
    crossers, n_lo, n_kept = torch.stack(
        [(mig_dn | mig_up).sum(), first_live, live.sum()]).tolist()
    if crossers:
        return None
    lane = _lane(length, live.device)
    span = n_lo + n_kept
    return torch.cat([lane[n_lo:span], lane[:n_lo], lane[span:]])


def _categories(kept, mig_dn, mig_up, m_cap: int) -> torch.Tensor:
    """uint8 category of each row after integration, dn-migrant 0 < kept 1
    < up-migrant 2 < dead 3, and m_cap dead rows behind them: what
    `_final_hop`'s stable sort orders."""
    cat = torch.where(mig_dn, 0, torch.where(mig_up, 2, torch.where(kept, 1, 3)))
    return torch.cat([cat, cat.new_full((m_cap,), 3)]).to(torch.uint8)


def _sort_branch(cat: torch.Tensor) -> torch.Tensor:
    """The category sort's order (the branch with crossers)."""
    return torch.sort(cat, stable=True).indices


def _skip_branch(cat: torch.Tensor) -> torch.Tensor:
    """The rotation `_skip_order` gives, from the categories of a rank
    without crossers (its live rows all kept, category 1): the first
    n_lo + n_kept rows rotated by n_lo, the rest in place."""
    kept = cat == 1
    n_lo = kept.to(torch.int32).argmax()  # 0 where no row is live
    n_kept = kept.sum()
    lane = torch.arange(cat.numel(), device=cat.device)
    return torch.where(lane < n_kept, lane + n_lo,
                       torch.where(lane < n_lo + n_kept, lane - n_kept, lane))


def _graphed_order(live, mig_dn, mig_up, m_cap: int, skip: bool):
    """The migration branch of a graphed body, with no host read: (order,
    int32[2] (sorts, skips)). Where the skip applies, tpusph's `lax.cond`
    on the device: the rotation (`_skip_branch`) is computed every step,
    the category sort only where a row crosses a face (a conditional node
    on a card, `graphs.device_if`), and the crossers select between the
    two. Otherwise the sort runs (order None)."""
    if not skip:
        one = torch.ones((), dtype=torch.int32, device=live.device)
        return None, torch.stack([one, one - 1])
    crossers = (mig_dn | mig_up).any()
    cat = _categories(live & ~mig_dn & ~mig_up, mig_dn, mig_up, m_cap)
    order = device_if(crossers, _sort_branch, (cat,), _skip_branch(cat))
    return order, torch.stack([crossers, ~crossers]).to(torch.int32)


def _final_hop(nrows, tag, live, mig_dn, mig_up, c_dev: int, m_cap: int, line, order=None):
    """The last migration hop and the kept-first repacking, by one stable
    category sort: dn-migrants < kept < up-migrants < dead, so the sorted
    rows are both direction buffers (the prefix, the slice after the kept
    block) and the compacted state (the middle block). A particle cannot
    cross both faces. `nrows` [6, n] and `tag` are the rows after
    integration (a tag ≥ 0 is a live pid), `line` the line of ranks
    across the faces. `order`, where given, is the sort's order found
    without sorting (`_skip_order`). Arrivals scatter into the free tail
    of `c_dev` slots. Returns (x, v, valid_new, pid_new, overflow, max_send): the
    overflow of the two direction buffers, of the kept block beyond c_dev
    (rows that arrived on earlier axes can exceed it; local rows alone
    cannot) and of the free tail, not yet reduced."""
    dev = nrows.device
    kept = live & ~mig_dn & ~mig_up
    n_dn, n_up, n_kept = mig_dn.sum(), mig_up.sum(), kept.sum()
    ovf_mig = (n_dn - m_cap).clamp(min=0) + (n_up - m_cap).clamp(min=0)
    ovf_mig = ovf_mig + (n_kept - c_dev).clamp(min=0)

    # m_cap dead rows behind the sort keep the kept and up slices below in
    # bounds for any capacities whenever the overflow flags are clean
    # (n_dn ≤ m_cap ⇒ kept fits; n_dn + n_kept ≤ c_dev ⇒ up fits)
    if order is None:
        order = _sort_branch(_categories(kept, mig_dn, mig_up, m_cap))
    mrows = torch.cat([nrows, nrows.new_zeros((6, m_cap))], dim=1).index_select(1, order)
    mtag = torch.cat([tag, tag.new_full((m_cap,), -2)]).index_select(0, order)

    lane = _lane(m_cap, dev)
    up0 = n_dn + n_kept
    (in_lo, in_lo_tag, in_lo_valid), (in_hi, in_hi_tag, in_hi_valid) = line.exchange(
        [_take(mrows, up0, m_cap), _take(mtag, up0, m_cap), lane < n_up],
        [mrows[:, :m_cap], mtag[:m_cap], lane < n_dn],
    )

    # pack the arrivals so that arrival j pairs with the j-th free slot
    (inc, inc_tag), inc_valid, _, _ = _compact(
        torch.cat([in_lo_valid, in_hi_valid]),
        (torch.cat([in_lo, in_hi], dim=1).T, torch.cat([in_lo_tag, in_hi_tag])),
        2 * m_cap,
    )

    # kept block → the first c_dev slots; arrivals go into the free tail.
    # One spare slot behind the rows takes the writes that are dropped.
    orows = torch.cat([_take(mrows, n_dn, c_dev), mrows.new_zeros((6, 1))], dim=1)
    otag = torch.cat([_take(mtag, n_dn, c_dev), mtag.new_zeros(1)])
    valid_new = torch.cat([_lane(c_dev, dev) < n_kept, live.new_zeros(1)])
    idx = n_kept + _lane(2 * m_cap, dev)
    write = inc_valid & (idx < c_dev)
    dev_overflow = (inc_valid & (idx >= c_dev)).sum()
    widx = torch.where(write, idx, c_dev)
    orows.index_copy_(1, widx, inc.T.contiguous())
    otag.index_copy_(0, widx, inc_tag)
    valid_new.index_fill_(0, widx, True)
    orows, otag, valid_new = orows[:, :c_dev], otag[:c_dev], valid_new[:c_dev]

    x = orows[:3].T.contiguous()
    v = orows[3:].T.contiguous()
    pid_new = torch.where(valid_new, otag, -1)
    return x, v, valid_new, pid_new, ovf_mig + dev_overflow, torch.maximum(n_dn, n_up)


def _local_step(
    pos, vel, valid, pid, click_cell, click_active, cfg: SimConfig, dcfg: DistConfig,
    comm: SlabComm, backend: str = "kernels", with_click: bool = True,
    tally: list | None = None,
):
    """One timestep on one rank's slab: `_device_build` (sort and halo
    exchange), then `_device_update` (kernels, integration, migration).
    Returns (x, v, valid, pid, sums, maxes): the counters of this rank, not
    yet reduced, as `comm.reduce` takes them (sums in DistAux's order, then
    the peaks). `tally` as in `_device_update`."""
    *inter, halo_ovf, oob, halo_send = _device_build(pos, vel, valid, pid, cfg, dcfg, comm)
    x, v, valid_new, pid_new, (ovf_w, mig_ovf, misrouted, n_valid, mig_send) = _device_update(
        *inter, click_cell, click_active, cfg, dcfg, comm, backend, with_click=with_click,
        tally=tally,
    )
    return (x, v, valid_new, pid_new, [halo_ovf, mig_ovf, ovf_w, oob, misrouted, n_valid],
            [n_valid, halo_send, mig_send])


def _device_step(
    pos, vel, valid, pid, click_cell, click_active, cfg: SimConfig, dcfg: DistConfig,
    comm: SlabComm, backend: str = "kernels", with_click: bool = True,
):
    """`_local_step`, the counters reduced over the ranks into a DistAux."""
    *rows, sums, maxes = _local_step(pos, vel, valid, pid, click_cell, click_active, cfg, dcfg,
                                     comm, backend, with_click)
    sums, maxes = comm.reduce(sums, maxes)
    return (*rows, DistAux(*sums, *maxes))


def _prepare(cfg: SimConfig, dcfg: DistConfig, comm: SlabComm, backend: str) -> str:
    """The checks every `make_sharded_*` starts with, then `_kernels_for`.
    Returns the resolved backend."""
    dcfg.validate()
    _check_slab_width(cfg, dcfg)
    if comm.size != dcfg.n_devices:
        raise ValueError(f"{comm.size} ranks for a DistConfig of {dcfg.n_devices} slabs")
    return _kernels_for(cfg, comm, backend)


def _kernels_for(cfg: SimConfig, comm, backend: str) -> str:
    """The config and backend checks of the sharded engines; on a card the
    kernels are built here (and a card without nvcc refuses the step), so
    the first step does not pay for the build. Returns the resolved
    backend."""
    cfg.validate()
    backend = resolve_backend(backend)
    if backend not in ("kernels", "cell_list"):
        raise ValueError("the sharded engine needs the 'kernels' or 'cell_list' backend")
    if comm.device.type == "cuda" and backend == "kernels":
        from tpusph_torch.utils import cuda_build

        cuda_build.library()
    return backend


def _check_device(state: DistState, comm: SlabComm) -> None:
    if state.position.device.type != comm.device.type:
        raise ValueError(f"state is on {state.position.device}, the rank's device is {comm.device}")


# ----------------------------------------------------- a rank's graphs

_pending_branches: dict = {}  # device → int32[2] (sorts, skips) of replays not yet read


def _count_branches(branches: torch.Tensor) -> None:
    """Add a graphed body's (sorts, skips) to the counters: at once on the
    CPU; on a card kept on the device until `migration_counts` reads them,
    since a read after each replay would wait on the card."""
    global migration_sorts, migration_skips
    dev = branches.device
    if dev.type == "cpu":
        sorts, skips = branches.tolist()
        migration_sorts += sorts
        migration_skips += skips
    elif dev in _pending_branches:
        _pending_branches[dev] += branches
    else:
        _pending_branches[dev] = branches.clone()  # not a graph's own tensor


def migration_counts() -> tuple[int, int]:
    """(migration_sorts, migration_skips), the branches of graphed steps on
    a card added in first: one read of each card that has some."""
    global migration_sorts, migration_skips
    for branches in _pending_branches.values():
        sorts, skips = branches.tolist()
        migration_sorts += sorts
        migration_skips += skips
    _pending_branches.clear()
    return migration_sorts, migration_skips


def _branches(tally: list):
    """int32[2] (sorts, skips) summed over a graphed body's migration
    steps; None where it has none."""
    if not tally:
        return None
    if len(tally) == 1:
        return tally[0]
    return torch.stack(tally).sum(0, dtype=torch.int32)


def _fold(acc, sums, maxes, device) -> torch.Tensor:
    """A production run's counters of this rank after one more step, in
    DistAux's order before the reduction: the five overflow sums summed,
    the particle count the last step's, the three peaks maxed. `acc` None:
    the first step's."""
    new = int32s([*sums, *maxes], device)
    if acc is None:
        return new
    return torch.cat([acc[:5] + new[:5], new[5:6], torch.maximum(acc[6:], new[6:])])


def _reduce_folded(reduce, acc) -> list:
    """The run's DistAux fields from the folded counters, reduced over the
    ranks once: five int64 sums (the eager run's fold sums int32 counters
    into int64) and four int32."""
    sums, maxes = reduce(acc[:6].unbind(), acc[6:].unbind())
    return [sums[:5].to(torch.int64), torch.cat([sums[5:], maxes])]


class RankGraphs:
    """The graphed entry points of one rank of a line or grid, tpusph's
    jitted dispatches: each a `SegmentedLoop` (`engine/graphs.py`), its
    body run under the capture guard on the CPU. On a rank with no peer a
    body is one CUDA-graph replay on a card; on a rank with peers a chain
    of replays split at each exchange and reduce, the transports between
    them. Graphs are keyed by the static choices `statics()` reads from the
    environment at each call, as the eager functions read them at each
    step. The engine's per-rank functions: `local_step(pos, vel, valid,
    pid, cell, active, with_click, tally)` (`_local_step`'s contract),
    `device_build(pos, vel, valid, pid)` and `device_update(*rows,
    with_click, tally)` (`tally` as in `_device_update`)."""

    def __init__(self, comm, statics, local_step, device_build, device_update):
        self.comm = comm
        self.statics = statics
        self.local_step = local_step
        self.device_build = device_build
        self.device_update = device_update
        self.loops: dict = {}
        self.one = torch.ones((), dtype=torch.int32)

    def _loop(self, key, body, **kw) -> SegmentedLoop:
        """The loop of `key`, made from `body(inputs, tally)` at its first
        call; its last output is its migration branches (None: it has
        none)."""
        if key not in self.loops:
            def counted(inputs):
                tally = []
                out = body(inputs, tally)
                return [*out, _branches(tally)]

            self.loops[key] = SegmentedLoop(counted, self.comm.device, **kw)
        return self.loops[key]

    def structures(self) -> dict:
        """{key: the chain its loop's first call found} (`SegmentedLoop.structure`)."""
        return {key: loop.structure for key, loop in self.loops.items()}

    def _call(self, key, body, inputs=None, **kw) -> list:
        """The outputs of the loop of `key`, its migration branches
        counted."""
        *out, branches = self._loop(key, body, **kw)(inputs)
        if branches is not None:
            _count_branches(branches)
        return out

    def step(self, cfg: SimConfig):
        local_step, reduce = self.local_step, self.comm.reduce

        def body(inputs, tally, clicked):
            pos, vel, valid, pid, *click = inputs
            cell, active = click if clicked else (None, False)
            *rows, sums, maxes = local_step(pos, vel, valid, pid, cell, active, clicked, tally)
            return [*rows, *reduce(sums, maxes)]  # a step with peers ends at the reduce

        def step(state: DistState, click_px=None, click_active=None):
            _check_device(state, self.comm)
            clicked = click_px is not None and (click_active is None or bool(click_active))
            inputs = list(state)
            if clicked:
                px, py = (int(v) for v in np.asarray(click_px))
                cell = torch.tensor(click_cell_from_px(px, py, cfg), dtype=torch.int32)
                inputs += [cell, self.one]
            key = ("step", clicked, *self.statics())
            *rows, sums, maxes = self._call(key, functools.partial(body, clicked=clicked), inputs)
            return DistState(*rows), DistAux(*sums.unbind(), *maxes.unbind())

        step.graphs = self
        return step

    def timed(self):
        reduce, device_build, device_update = self.comm.reduce, self.device_build, \
            self.device_update

        def build_body(inputs, tally):
            *inter, halo_ovf, oob, halo_send = device_build(*inputs)
            return [*inter, *reduce([halo_ovf, oob], [halo_send])]

        def update_body(inputs, tally):
            # the build's inputs, then its outputs: rows, sums, maxes, branches
            *inter, (halo_ovf, oob), (halo_send,), _ = inputs[len(DistState._fields):]
            x, v, valid, pid, (ovf_w, mig_ovf, misrouted, n_valid, mig_send) = device_update(
                *inter, False, tally)
            (ovf_w, mig_ovf, misrouted, total), (max_dev, mig_send) = reduce(
                [ovf_w, mig_ovf, misrouted, n_valid], [n_valid, mig_send])
            aux = DistAux(halo_ovf, mig_ovf, ovf_w, oob, misrouted, total, max_dev, halo_send,
                          mig_send)
            # a host-staged reduce run eagerly (the warm-up) leaves its sums on
            # the host; inside a graph they are the device's receive tensors
            return [x, v, valid, pid, torch.stack([a.to(x.device) for a in aux])]

        handed = {}  # the rows the last build handed out

        def build(state: DistState):
            _check_device(state, self.comm)
            key = ("build", *self.statics())
            *inter, sums, maxes = self._call(key, build_body, list(state), clone=False)
            handed["inter"], handed["key"] = tuple(inter), key
            return handed["inter"], *sums.unbind(), *maxes.unbind()

        def update(inter, halo_ovf, oob, halo_send):
            if inter is not handed.get("inter"):
                raise ValueError("a graphed update takes what the last build returned")
            key = ("update", *handed["key"][1:])
            x, v, valid, pid, aux = self._call(key, update_body,
                                               after=self.loops[handed["key"]])
            return DistState(x, v, valid, pid), DistAux(*aux.unbind())

        build.graphs = update.graphs = self
        return build, update

    def run(self, steps: int):
        """`steps` steps without a click, the counters folded on the card
        each step (`_fold`) and reduced once after the last. With no peer
        the whole chain is one graph (`lax.scan`'s one dispatch). With peers
        one step's chain is replayed `steps` times, the state and the
        folded counters carried in its own input tensors, then the
        reduction: a chain unrolled over the steps would be hundreds of
        graphs and a capture as long as the run."""
        local_step, reduce, device = self.local_step, self.comm.reduce, self.comm.device

        def fields(outputs):
            s5, rest = outputs
            return DistAux(*s5.unbind(), *rest.unbind())

        if self.comm.size == 1:
            def chain(inputs, tally):
                state, acc = inputs, None
                for _ in range(steps):
                    *state, sums, maxes = local_step(*state, None, False, False, tally)
                    acc = _fold(acc, sums, maxes, device)
                return [*state, *_reduce_folded(reduce, acc)]

            def run(state: DistState):
                _check_device(state, self.comm)
                *rows, s5, rest = self._call(("run", *self.statics()), chain, list(state))
                return DistState(*rows), fields((s5, rest))

            run.graphs = self
            return run

        def one_step(inputs, tally):
            *state, acc = inputs
            *new, sums, maxes = local_step(*state, None, False, False, tally)
            acc.copy_(_fold(acc, sums, maxes, device))
            for dst, src in zip(state, new):
                dst.copy_(src)
            return []

        def fold(inputs, tally):
            return _reduce_folded(reduce, inputs[len(DistState._fields)])

        def run(state: DistState):
            _check_device(state, self.comm)
            key = ("run", *self.statics())
            loop = self._loop(key, one_step, clone=False)
            # the body writes its inputs: the caller's state is copied
            # first (the card copies it into the graph's own tensors)
            start = [t.clone() for t in state]
            start.append(torch.zeros(len(DistAux._fields), dtype=torch.int32, device=device))
            for k in range(steps):
                (branches,) = loop(start if k == 0 else loop.inputs)
                if branches is not None:
                    _count_branches(branches)
            rows = [t.clone() for t in loop.inputs[:len(DistState._fields)]]
            return DistState(*rows), fields(self._call(("fold", *key[1:]), fold, after=loop))

        run.graphs = self
        return run


def _rank_graphs(cfg: SimConfig, dcfg: DistConfig, comm: SlabComm, backend: str) -> RankGraphs:
    """The z-slab engine's per-rank functions as `RankGraphs`, keyed by the
    machinery switch and the skip's."""
    return RankGraphs(
        comm, lambda: (_elide_single(dcfg), _force_migsort()),
        lambda pos, vel, valid, pid, cell, active, with_click, tally: _local_step(
            pos, vel, valid, pid, cell, active, cfg, dcfg, comm, backend,
            with_click=with_click, tally=tally),
        lambda *state: _device_build(*state, cfg, dcfg, comm),
        lambda *rows: _device_update(*rows[:8], None, False, cfg, dcfg, comm, backend,
                                     with_click=rows[8], tally=rows[9]),
    )


def make_sharded_step(cfg: SimConfig, dcfg: DistConfig, comm: SlabComm, backend: str = "kernels"):
    """`step(state, click_px=None, click_active=None) -> (DistState,
    DistAux)` for this rank's block on `comm.device`, tpusph's jitted
    step (`tpusph/dist/sharded.py:707-757`); every rank of the line calls
    it once a timestep. `kernels` (also under tpusph's names `auto` and
    `pallas`) runs the rank, density and force kernels on each rank;
    `cell_list` the plain-torch tile passes.

    On a card the step is CUDA-graph replays (`RankGraphs`), one chain for
    the step without a click and one for the step with one, whose cell and
    gain go in as device int32 tensors: on a line of one rank one replay;
    with peers three segments, split at the halo exchange and the
    migration exchange and ending at the reduce, the transports between
    them. On the CPU the same bodies run under the capture guard.
    `step.eager` is the same step as eager operations."""
    backend = _prepare(cfg, dcfg, comm, backend)

    def eager(state: DistState, click_px=None, click_active=None):
        """click_px: host pixel coordinates, the same on every rank, or
        None. The pixel → cell conversion is float32 on the host
        (`impulse.click_cell_from_px`). Without a click the kick is left
        out, not multiplied by 0."""
        _check_device(state, comm)
        clicked = click_px is not None and (click_active is None or bool(click_active))
        cell = None
        if clicked:
            px, py = (int(v) for v in np.asarray(click_px))
            cell = click_cell_from_px(px, py, cfg)
        x, v, valid, pid, aux = _device_step(
            *state, cell, clicked, cfg, dcfg, comm, backend, with_click=clicked
        )
        return DistState(x, v, valid, pid), aux

    step = _rank_graphs(cfg, dcfg, comm, backend).step(cfg)
    step.eager = eager
    return step


def make_sharded_timed(cfg: SimConfig, dcfg: DistConfig, comm: SlabComm, backend: str = "kernels"):
    """The step in two stages, for the timed protocol (the reference's
    per-phase report, times.h:12-36; tpusph `dist/sharded.py:760-844`):

      build(state) -> (sorted rows, halo_ovf, oob, halo_send)
          the sort and the halo exchange, the "grid construction" phase
      update(inter, halo_ovf, oob, halo_send) -> (DistState, DistAux)
          kernels, integration and migration, the "SPH update" phase,
          without the click, as the reference's simulateAndTime runs the
          step without mouse handling (simulator.cu:499-546)

    so that a driver can fence each phase. The counters each stage returns
    are already reduced over the ranks. Returns (build, update).

    On a card each stage is CUDA-graph replays (`RankGraphs`; one replay
    on a line of one rank, segments between the transports with peers):
    what `build` returns is the graph's own tensors, valid until the next
    `build`, and `update` takes them and reads them in place.
    `build.eager` and `update.eager` are the eager stages."""
    backend = _prepare(cfg, dcfg, comm, backend)

    def build_eager(state: DistState):
        _check_device(state, comm)
        *inter, halo_ovf, oob, halo_send = _device_build(*state, cfg, dcfg, comm)
        (halo_ovf, oob), (halo_send,) = comm.reduce([halo_ovf, oob], [halo_send])
        return tuple(inter), halo_ovf, oob, halo_send

    def update_eager(inter, halo_ovf, oob, halo_send):
        x, v, valid, pid, (ovf_w, mig_ovf, misrouted, n_valid, mig_send) = _device_update(
            *inter, None, False, cfg, dcfg, comm, backend, with_click=False
        )
        (ovf_w, mig_ovf, misrouted, total), (max_dev, mig_send) = comm.reduce(
            [ovf_w, mig_ovf, misrouted, n_valid], [n_valid, mig_send]
        )
        aux = DistAux(
            halo_overflow=halo_ovf, migration_overflow=mig_ovf, window_overflow=ovf_w,
            oob_count=oob, misrouted=misrouted, num_particles=total,
            max_dev_particles=max_dev, max_halo_send=halo_send, max_migration_send=mig_send,
        )
        return DistState(x, v, valid, pid), aux

    build, update = _rank_graphs(cfg, dcfg, comm, backend).timed()
    build.eager, update.eager = build_eager, update_eager
    return build, update


def make_sharded_run(
    cfg: SimConfig, dcfg: DistConfig, comm: SlabComm, steps: int, backend: str = "kernels"
):
    """`run(state) -> (DistState, DistAux)`: `steps` sharded timesteps
    without a click, the production loop (tpusph `dist/sharded.py:847-904`).
    The five overflow, misrouting and oob counters are summed over the
    chain, `num_particles` is the last step's, the three peaks are maxed,
    all on the device; nothing is read back between the steps.

    On a card (`RankGraphs.run`): on a line of one rank the whole chain is
    one CUDA-graph replay, as tpusph's is one dispatch of a `lax.scan`;
    with peers one step's segments are replayed `steps` times, the
    counters folded on the card and reduced once after the last.
    `run.eager` is a Python loop of eager steps."""
    backend = _prepare(cfg, dcfg, comm, backend)

    def eager(state: DistState):
        _check_device(state, comm)
        fields, auxs = tuple(state), []
        for _ in range(steps):
            *fields, aux = _device_step(
                *fields, None, False, cfg, dcfg, comm, backend, with_click=False
            )
            auxs.append(torch.stack(aux))
        auxs = torch.stack(auxs)  # [steps, 9], DistAux's order
        aux = DistAux(*auxs[:, :5].sum(dim=0), auxs[-1, 5], *auxs[:, 6:].amax(dim=0))
        return DistState(*fields), aux

    run = _rank_graphs(cfg, dcfg, comm, backend).run(steps)
    run.eager = eager
    return run


# ------------------------------------------------------------------- host IO
def slab_owner(z: np.ndarray, cfg: SimConfig, dcfg: DistConfig) -> np.ndarray:
    """The owning rank of each z on the host, the mirror of the step's
    migration predicate: cell space with explicit slab planes, float
    equal-width otherwise."""
    d_count = dcfg.n_devices
    if dcfg.slab_planes is not None:
        zc = np.clip(
            (np.asarray(z, np.float32) / np.float32(cfg.h)).astype(np.int32),
            0, cfg.num_cells_per_dim - 1,
        )
        interior = np.asarray(dcfg.slab_planes[1:-1], np.int64)
        return np.searchsorted(interior, zc, side="right")
    slab_w = cfg.box_dim / d_count
    return np.clip((np.asarray(z) / slab_w).astype(np.int64), 0, d_count - 1)


def balanced_slab_planes(z: np.ndarray, cfg: SimConfig, n_devices: int) -> tuple:
    """Cell-aligned slab edges that equalise the occupancy of the slabs for
    the given z snapshot (host side). Equal-width slabs are unbalanced by
    construction (random init fills [1, box − 1] only, grid init one
    corner), and any D whose equal-width faces miss the cell planes pays a
    full-width merge sort a step. Occupancy quantiles snapped to cell
    planes repair both. Gaps are clamped to ≥ 2 cells, the 2h ghost
    layer's minimum."""
    C, D = cfg.num_cells_per_dim, n_devices
    zc = np.clip((np.asarray(z, np.float32) / np.float32(cfg.h)).astype(np.int32), 0, C - 1)
    cdf = np.cumsum(np.bincount(zc, minlength=C))  # cdf[c] = #(zc ≤ c)
    n = int(cdf[-1])
    planes = [0]
    for k in range(1, D):
        # the smallest plane p with count(zc < p) ≥ k·n/D
        p = int(np.searchsorted(cdf, k * n / D) + 1)
        p = min(max(p, planes[-1] + 2), C - 2 * (D - k))
        planes.append(p)
    planes.append(C)
    return tuple(planes)


def distribute_state(state, cfg: SimConfig, dcfg: DistConfig, comm: SlabComm) -> DistState:
    """This rank's padded block of a whole state (a FluidState, or anything
    with position, velocity and valid), on `comm.device`. Every rank calls
    it with the same state and keeps the particles of its own z-slab; pid
    is the particle's row in `state`. A slab that holds more than
    `dev_capacity` particles raises on every rank."""
    pos, vel, valid = (
        np.asarray(torch.as_tensor(a).cpu()) for a in (state.position, state.velocity, state.valid)
    )
    c_dev = dcfg.dev_capacity
    owner = slab_owner(pos[:, 2], cfg, dcfg)
    for dev, need in enumerate(np.bincount(owner[valid], minlength=dcfg.n_devices)):
        if need > c_dev:
            raise ValueError(f"device {dev} needs {need} slots > dev_capacity {c_dev}")
    idx = np.nonzero(valid & (owner == comm.rank))[0]
    k = len(idx)
    gx = np.zeros((c_dev, 3), np.float32)
    gv = np.zeros((c_dev, 3), np.float32)
    gvalid = np.zeros((c_dev,), bool)
    gpid = np.full((c_dev,), -1, np.int32)
    gx[:k], gv[:k], gvalid[:k], gpid[:k] = pos[idx], vel[idx], True, idx
    return DistState(*(torch.from_numpy(a).to(comm.device) for a in (gx, gv, gvalid, gpid)))


def collect_state(dist: DistState, num_particles: int, comm: SlabComm) -> dict:
    """Gather every rank's block and order the particles by pid:
    {position, velocity}, f32[N, 3] numpy, NaN where a pid is missing.
    Every rank calls it and every rank gets the whole state. The span
    `dist.collect` covers it while a profile records.

    The order by pid runs on the device that holds the blocks: position
    and velocity are scattered with `index_copy_` into one NaN-filled
    (2, N + 1, 3) tensor, a live row (valid, pid >= 0) to row pid and
    every other row to the dump row N, so no boolean mask syncs the host.
    That tensor then goes to the host in one copy, into a fresh pinned
    tensor on a CUDA device, and the two arrays are its halves without
    row N: fresh on every call, writable, C-contiguous. A pid on two live
    rows (a conservation fault) keeps either row's values; a pid >= N is
    an index error."""
    with span("dist.collect"):
        blocks = comm.gather(list(dist))
        pos, vel, valid, pid = (torch.cat([b[i] for b in blocks]) for i in range(4))
        idx = torch.where(valid & (pid >= 0), pid.long(), num_particles)
        out = torch.full((2, num_particles + 1, 3), float("nan"), dtype=pos.dtype,
                         device=pos.device)
        out[0].index_copy_(0, idx, pos)
        out[1].index_copy_(0, idx, vel)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
        host = host.copy_(out).numpy()
    return {"position": host[0, :num_particles], "velocity": host[1, :num_particles]}
