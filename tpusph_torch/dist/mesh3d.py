"""3-D brick sharding, the generalisation of the z-slab engine of
`dist/sharded.py`. Counterpart of `tpusph/dist/mesh3d.py`, function for
function.

The box is split into bricks over a (z, y, x) grid of ranks; each rank owns
the particles resident in its brick. The JAX package runs one per-device
function under `shard_map` over a (z, y, x) `Mesh`. Here every rank is a
process (`torch.distributed`, SPMD) holding its brick's padded `DistState`
block, and `dist/comm.py::BrickComm` stands where the mesh collectives
stood: `comm.axis(ax)` is the line of ranks through this one along an
axis, and `lax.axis_index` is this rank's coordinate on it, a host int, so
the brick's bounds and every capacity are host constants. The
27-neighbourhood communication uses the staged-axis scheme, three face
exchanges instead of 26 point-to-point sends, edge and corner rows
forwarded transitively:

  staged 2h halo exchange (positions, velocities, valid; one round):
    phase z: local rows within 2h of the brick's z faces go to the ranks
             ±1 along z → halo set Hz.
    phase y: rows of local ∪ Hz within 2h of the y faces → Hy (z-edge and
             corner rows ride along).
    phase x: rows of local ∪ Hz ∪ Hy within 2h of the x faces → Hx.
  The final set covers the whole L∞ 2h shell, so every halo copy within h
  of the brick sees all of its own neighbours locally and its density is
  exact; there is no second round (the slab engine's argument). Needs
  bricks ≥ 2h wide along every axis (checked when a step is made).
  Density and force run on the combined rows (`sharded._compute_sorted_fields`:
  the rank, density and force kernels on `dev_capacity + 2·Σ halo_capacity`
  rows), then integration of the local rows.
  Migration: three one-hop phases (z, then y, then x). The z and y hops
  pack both direction buffers from one category sort and append their
  arrivals, so a diagonal brick-corner crosser reaches its owner within one
  step by axis-by-axis hops; the x hop and the compaction are one category
  sort (`sharded._final_hop`).

All buffers have fixed capacity with overflow detection, never a silent
drop, and a misrouting counter per axis for the one-hop-per-axis
invariant. Offsets that depend on the data stay 0-d tensors on the device
(`sharded._take`), so a step reads nothing back. A (1, 1, 1) grid runs the
whole machinery, every exchange returning zeros: the JAX package elides
nothing here either. Each step, timed phase and production chain is
CUDA-graph replays on a card (`sharded.RankGraphs`), as tpusph jits each
as one dispatch: one replay on a (1, 1, 1) grid; with peers segments
split at each exchange along an axis that has a peer (the halo phases and
the migration hops) and ending at the reduce, the transports between
them: a (1, 2, 2) grid has four exchanges a step, a (2, 2, 2) grid six.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.dist.comm import BrickComm
from tpusph_torch.dist.sharded import (
    DistAux,
    DistState,
    RankGraphs,
    _check_device,
    _compact,
    _compute_sorted_fields,
    _final_hop,
    _kernels_for,
    _lane,
    balanced_slab_planes,
)
from tpusph_torch.interact.impulse import click_cell_from_px, click_kick_fields
from tpusph_torch.neighbors.grid import compute_keys_fields, h_tensor
from tpusph_torch.physics.integrate import integrate_fields

AXES = ("z", "y", "x")
AXIS_DIM = {"z": 2, "y": 1, "x": 0}  # position column per axis name
F = np.float32


@dataclasses.dataclass(frozen=True)
class Mesh3DConfig:
    """Static capacities of the brick-sharded engine, all per rank."""

    mesh_shape: tuple[int, int, int]  # ranks along (z, y, x)
    dev_capacity: int
    halo_capacity: tuple[int, int, int]  # rows a direction, per axis phase
    migration_capacity: tuple[int, int, int]
    # Optional balance-aware partition: per axis (z, y, x order) an
    # ascending tuple of m_ax + 1 cell-plane indices giving coordinate d
    # the cells [planes[d], planes[d+1]) along that axis, the 3-D analog of
    # DistConfig.slab_planes. `balanced_brick_planes` computes them;
    # `DistSimulator.setup` applies them by default. None = equal widths.
    axis_planes: tuple | None = None

    def validate(self) -> None:
        if len(self.mesh_shape) != 3 or any(m < 1 for m in self.mesh_shape):
            raise ValueError(f"mesh_shape must be 3 positive ints, got {self.mesh_shape}")
        if self.dev_capacity <= 0 or self.dev_capacity % 8:
            raise ValueError("dev_capacity must be a positive multiple of 8")
        for name, caps in (("halo", self.halo_capacity), ("migration", self.migration_capacity)):
            for v in caps:
                if v <= 0 or v % 8:
                    raise ValueError(f"{name}_capacity entries must be positive multiples of 8")


def _check_brick_widths(cfg: SimConfig, mcfg: Mesh3DConfig) -> None:
    """The 2h ghost layer needs bricks at least 2h wide along every axis.
    With explicit axis planes that is a gap of ≥ 2 cells per axis, besides
    the shape and monotonicity of the planes."""
    if mcfg.axis_planes is not None:
        C = cfg.num_cells_per_dim
        if len(mcfg.axis_planes) != 3:
            raise ValueError(
                f"axis_planes must have one plane tuple per mesh axis, got {mcfg.axis_planes}"
            )
        for ax_i, (m, pl) in enumerate(zip(mcfg.mesh_shape, mcfg.axis_planes)):
            pl = tuple(int(p) for p in pl)
            if len(pl) != m + 1 or pl[0] != 0 or pl[-1] != C:
                raise ValueError(
                    f"axis_planes[{AXES[ax_i]}] must be {m + 1} cell planes spanning "
                    f"[0, {C}], got {pl}"
                )
            gaps = [b - a for a, b in zip(pl, pl[1:])]
            if min(gaps) < 2:
                raise ValueError(
                    f"axis_planes[{AXES[ax_i]}] gaps {gaps}: every brick needs ≥ 2 cells "
                    "per axis (2h ghost layer)"
                )
        return
    for ax_i, m in enumerate(mcfg.mesh_shape):
        if cfg.box_dim / m < 2 * cfg.h:
            raise ValueError(
                f"brick width {cfg.box_dim / m:.4f} along {AXES[ax_i]} < 2h = "
                f"{2 * cfg.h:.4f}: at most {int(cfg.box_dim // (2 * cfg.h))} ranks per axis"
            )


def _brick_geometry(cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm):
    """Per-axis (lo, hi, width) of this rank's brick as float32 values,
    computed as the JAX package computes them (`jnp.float32(box_dim) / m`,
    `d · w`). With explicit axis planes the bounds are plane·h and only
    informative: the halo bands and migration predicates then run in cell
    space (`_axis_bands`, `_axis_migration`)."""
    lo, hi, widths = {}, {}, {}
    for ax_i, ax in enumerate(AXES):
        d = comm.coords[ax_i]
        if mcfg.axis_planes is not None:
            pl = np.asarray(mcfg.axis_planes[ax_i], F) * F(cfg.h)
            lo[ax], hi[ax] = pl[d], pl[d + 1]
            widths[ax] = F(hi[ax] - lo[ax])
        else:
            w = F(cfg.box_dim) / F(mcfg.mesh_shape[ax_i])
            lo[ax] = F(d) * w
            hi[ax] = F(lo[ax] + w)
            widths[ax] = w
    return lo, hi, widths


def _cellspace(coord: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """f32 coordinate → clamped cell index, the truncation the build's keys
    use (`neighbors.grid.cell_coords`)."""
    C = cfg.num_cells_per_dim
    return (coord / h_tensor(cfg, coord.device)).to(torch.int32).clamp(0, C - 1)


def _axis_bands(coord, cvalid, ax_i: int, cfg: SimConfig, mcfg: Mesh3DConfig,
                comm: BrickComm, lo, hi):
    """(send_dn, send_up) 2h halo-layer masks along one axis. With explicit
    axis planes the bands are 2-cell bands at the plane faces (integer
    supersets of the float 2h bands, `sharded._band_thresholds`'
    argument); equal-width bricks compare floats."""
    ax = AXES[ax_i]
    if mcfg.axis_planes is not None:
        pl = mcfg.axis_planes[ax_i]
        d = comm.coords[ax_i]
        cc = _cellspace(coord, cfg)
        return cvalid & (cc < pl[d] + 2), cvalid & (cc >= pl[d + 1] - 2)
    halo_w = F(2.0 * cfg.h)
    return (cvalid & (coord < float(F(lo[ax] + halo_w))),
            cvalid & (coord >= float(F(hi[ax] - halo_w))))


def _axis_migration(coord, lv, ax_i: int, cfg: SimConfig, mcfg: Mesh3DConfig,
                    comm: BrickComm, lo, hi, w):
    """(mig_dn, mig_up, misrouted_mask) along one axis for the coordinates
    after integration. With explicit axis planes ownership is decided in
    cell space, the truncation the next build's keys use, so migration,
    `distribute_state_3d` and the ownership invariant never disagree at a
    face; the one-hop bound uses the adjacent bricks' plane edges.
    Equal-width bricks compare floats."""
    ax = AXES[ax_i]
    if mcfg.axis_planes is not None:
        m = mcfg.mesh_shape[ax_i]
        pl = mcfg.axis_planes[ax_i]
        d = comm.coords[ax_i]
        cc = _cellspace(coord, cfg)
        far_lo, far_hi = pl[max(d - 1, 0)], pl[min(d + 2, m)]
        return lv & (cc < pl[d]), lv & (cc >= pl[d + 1]), lv & ((cc < far_lo) | (cc >= far_hi))
    mig_dn = lv & (coord < float(lo[ax]))
    mig_up = lv & (coord >= float(hi[ax]))
    mis = lv & ((coord < float(F(lo[ax] - w))) | (coord >= float(F(hi[ax] + w))))
    return mig_dn, mig_up, mis


def _halo_buffers(rows, send_dn, send_up, h_cap: int, disjoint: bool):
    """Pack the two 2h face layers of `rows` [6, n] into [6, h_cap] send
    buffers. Where the brick is ≥ 4h wide along this axis the dn and up
    sets are disjoint and one stable category sort yields both: the dn
    rows are the first h_cap of the order, the up rows its last h_cap,
    valid in the last n_up lanes. Narrower bricks take two `_compact`s.
    The slab engine slices key-sorted rows instead, but the y and x phases
    select by a coordinate that is not major in the key, so the category
    sort stays. Returns (dn6, dn_valid, up6, up_valid, overflow,
    max_send)."""
    n_dn, n_up = send_dn.sum(), send_up.sum()
    overflow = (n_dn - h_cap).clamp(min=0) + (n_up - h_cap).clamp(min=0)
    max_send = torch.maximum(n_dn, n_up)
    if disjoint:
        lane = _lane(h_cap, rows.device)
        cat = torch.where(send_dn, 0, torch.where(send_up, 2, 1)).to(torch.uint8)
        order = torch.sort(cat, stable=True).indices
        dn6 = rows.index_select(1, order[:h_cap])
        up6 = rows.index_select(1, order[order.numel() - h_cap:])
        return (dn6, lane < n_dn, up6, lane >= (h_cap - n_up.clamp(max=h_cap)),
                overflow, max_send)
    _, dn_valid, dn_take, _ = _compact(send_dn, (), h_cap)
    _, up_valid, up_take, _ = _compact(send_up, (), h_cap)
    return (rows.index_select(1, dn_take), dn_valid, rows.index_select(1, up_take), up_valid,
            overflow, max_send)


def _device_build3d(pos, vel, valid, pid, cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm):
    """Phase 1 on one rank's brick: the staged 2h halo exchange (z → y → x,
    corner rows forwarded, see the module docstring) and the cell-key sort
    of the combined rows. Returns the sorted rows (key_s, sx, sy, sz, svx,
    svy, svz, tag_s) and this rank's (halo_overflow, oob_count,
    max_halo_send), not yet reduced."""
    lo, hi, _widths = _brick_geometry(cfg, mcfg, comm)
    rows = torch.cat([pos, vel], dim=1).T  # [6, c_dev]
    cvalid = valid
    # a local valid row carries its pid (≥ 0), a local invalid slot −1, a
    # halo copy −2
    tag = torch.where(valid, pid, -1)
    halo_ovf, sends = 0, []
    for ax_i, ax in enumerate(AXES):
        m, h_cap = mcfg.mesh_shape[ax_i], mcfg.halo_capacity[ax_i]
        send_dn, send_up = _axis_bands(rows[AXIS_DIM[ax]], cvalid, ax_i, cfg, mcfg, comm, lo, hi)
        # dn and up sets disjoint (one category sort serves both)? 2-cell
        # bands need a gap of ≥ 4 cells, float 2h bands a width of ≥ 4h
        if mcfg.axis_planes is not None:
            pl = mcfg.axis_planes[ax_i]
            disjoint = min(b - a for a, b in zip(pl, pl[1:])) >= 4
        else:
            disjoint = cfg.box_dim / m >= 4 * cfg.h
        dn6, dn_valid, up6, up_valid, ovf, max_send = _halo_buffers(
            rows, send_dn, send_up, h_cap, disjoint
        )
        # from the rank below and from the rank above along this axis
        (lo6, lo_valid), (hi6, hi_valid) = comm.axis(ax_i).exchange(
            [up6, up_valid], [dn6, dn_valid]
        )
        rows = torch.cat([rows, lo6, hi6], dim=1)
        cvalid = torch.cat([cvalid, lo_valid, hi_valid])
        tag = torch.cat([tag, tag.new_full((2 * h_cap,), -2)])
        halo_ovf = halo_ovf + ovf
        sends.append(max_send)

    # invalid and stale slots parked at the origin (physically inert)
    rows = torch.cat([torch.where(cvalid, rows[:3], 0.0), rows[3:]])
    key, oob_count = compute_keys_fields(rows[0], rows[1], rows[2], cvalid, cfg)
    key_s, perm = torch.sort(key, stable=True)
    srows = rows.index_select(1, perm)
    halo_send = torch.stack(sends).amax()
    return (key_s, *srows, tag.index_select(0, perm), halo_ovf, oob_count, halo_send)


def _append_hop(cr, ctag, mig_dn, mig_up, m_cap: int, line):
    """A z or y migration hop: one stable category sort puts the
    dn-senders first and the up-senders last, the departures become
    vacated rows (tag −2), and the arrivals from both sides are appended
    (they may still hop along a later axis). Returns (rows, tags,
    overflow, max_send), the last two not yet reduced."""
    n_dn, n_up = mig_dn.sum(), mig_up.sum()
    overflow = (n_dn - m_cap).clamp(min=0) + (n_up - m_cap).clamp(min=0)
    cat = torch.where(mig_dn, 0, torch.where(mig_up, 2, 1)).to(torch.uint8)
    order = torch.sort(cat, stable=True).indices
    srows = cr.index_select(1, order)
    mtag = ctag.index_select(0, order)
    total = mtag.numel()
    lane = _lane(m_cap, cr.device)
    t0 = total - m_cap
    pos_i = _lane(total, cr.device)
    vacated = (pos_i < n_dn) | (pos_i >= total - n_up)
    (in_lo6, in_lo_tag, in_lo_valid), (in_hi6, in_hi_tag, in_hi_valid) = line.exchange(
        [srows[:, t0:], mtag[t0:], lane >= (m_cap - n_up.clamp(max=m_cap))],
        [srows[:, :m_cap], mtag[:m_cap], lane < n_dn],
    )
    inc_valid = torch.cat([in_lo_valid, in_hi_valid])
    inc_tag = torch.where(inc_valid, torch.cat([in_lo_tag, in_hi_tag]), -2)
    inc6 = torch.where(inc_valid, torch.cat([in_lo6, in_hi6], dim=1), 0.0)
    return (torch.cat([srows, inc6], dim=1), torch.cat([torch.where(vacated, -2, mtag), inc_tag]),
            overflow, torch.maximum(n_dn, n_up))


def _device_update3d(
    key_s, sx, sy, sz, svx, svy, svz, tag_s, click_cell, click_active,
    cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm, backend: str,
    with_click: bool = True,
):
    """Phase 2 on one rank's brick: density and force on the combined rows
    (`sharded._compute_sorted_fields`), integration, click impulse, and the
    migration hops z → y → x. The z and y hops append their arrivals; the
    x hop is the slab engine's merged migration and compaction sort
    (`sharded._final_hop`): one category sort dn < kept < up < dead gives
    both direction buffers and the kept-first state, arrivals scattered
    into the free tail. Returns (x, v, valid_new, pid_new, (window_ovf,
    migration_ovf, misrouted, n_valid, max_mig_send)), the counters not
    yet reduced."""
    lo, hi, widths = _brick_geometry(cfg, mcfg, comm)
    rho_s, _p_s, (fx, fy, fz), _valid_s, ovf_w = _compute_sorted_fields(
        key_s, sx, sy, sz, svx, svy, svz, cfg, backend
    )

    # ---- integrate live local rows; freeze halo copies and padding
    live = tag_s >= 0
    moved = integrate_fields(sx, sy, sz, svx, svy, svz, fx, fy, fz, rho_s, cfg)
    nx, ny, nz, nvx, nvy, nvz = (
        torch.where(live, a, b) for a, b in zip(moved, (sx, sy, sz, svx, svy, svz))
    )
    # click impulse: from the pre-step cells, before migration
    if with_click:
        kx, ky, kz = click_kick_fields(sx, sy, sz, live, click_cell, cfg)
        ca = torch.as_tensor(click_active, device=key_s.device).to(torch.float32)
        nvx, nvy, nvz = nvx + kx * ca, nvy + ky * ca, nvz + kz * ca

    # ---- migration: one hop per axis, z → y → x
    cr = torch.stack([nx, ny, nz, nvx, nvy, nvz])
    ctag = tag_s
    mig_ovf = misrouted = 0
    sends = []
    for ax_i, ax in enumerate(AXES):
        m_cap = mcfg.migration_capacity[ax_i]
        lv = ctag >= 0
        mig_dn, mig_up, mis_mask = _axis_migration(
            cr[AXIS_DIM[ax]], lv, ax_i, cfg, mcfg, comm, lo, hi, widths[ax]
        )
        misrouted = misrouted + mis_mask.sum()
        if ax != AXES[-1]:  # z and y: the arrivals are appended
            cr, ctag, ovf, send = _append_hop(cr, ctag, mig_dn, mig_up, m_cap, comm.axis(ax_i))
        else:
            x, v, valid_new, pid_new, ovf, send = _final_hop(
                cr, ctag, lv, mig_dn, mig_up, mcfg.dev_capacity, m_cap, comm.axis(ax_i)
            )
        mig_ovf = mig_ovf + ovf
        sends.append(send)
    mig_send = torch.stack(sends).amax()
    return x, v, valid_new, pid_new, (ovf_w, mig_ovf, misrouted, valid_new.sum(), mig_send)


def _local_step3d(
    pos, vel, valid, pid, click_cell, click_active, cfg: SimConfig, mcfg: Mesh3DConfig,
    comm: BrickComm, backend: str = "kernels", with_click: bool = True,
):
    """One timestep on one rank's brick: `_device_build3d` (staged halo
    exchange and sort), then `_device_update3d` (kernels, integration,
    migration). Returns (x, v, valid, pid, sums, maxes), the counters of
    this rank not yet reduced (`sharded._local_step`'s contract)."""
    *inter, halo_ovf, oob, halo_send = _device_build3d(pos, vel, valid, pid, cfg, mcfg, comm)
    x, v, valid_new, pid_new, (ovf_w, mig_ovf, misrouted, n_valid, mig_send) = _device_update3d(
        *inter, click_cell, click_active, cfg, mcfg, comm, backend, with_click=with_click
    )
    return (x, v, valid_new, pid_new, [halo_ovf, mig_ovf, ovf_w, oob, misrouted, n_valid],
            [n_valid, halo_send, mig_send])


def _device_step3d(
    pos, vel, valid, pid, click_cell, click_active, cfg: SimConfig, mcfg: Mesh3DConfig,
    comm: BrickComm, backend: str = "kernels", with_click: bool = True,
):
    """`_local_step3d`, the counters reduced over every rank into a DistAux."""
    *rows, sums, maxes = _local_step3d(pos, vel, valid, pid, click_cell, click_active, cfg,
                                       mcfg, comm, backend, with_click)
    sums, maxes = comm.reduce(sums, maxes)
    return (*rows, DistAux(*sums, *maxes))


def _prepare3d(cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm, backend: str) -> str:
    """The checks every `make_mesh3d_*` starts with, then
    `sharded._kernels_for` (on a card the kernels are built, or the step
    refused where nvcc is missing). Returns the resolved backend."""
    mcfg.validate()
    _check_brick_widths(cfg, mcfg)
    if getattr(comm, "shape", None) != tuple(mcfg.mesh_shape):
        raise ValueError(
            f"a brick grid {getattr(comm, 'shape', None)} for a Mesh3DConfig of "
            f"{tuple(mcfg.mesh_shape)}"
        )
    return _kernels_for(cfg, comm, backend)


def _rank_graphs3d(cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm,
                   backend: str) -> RankGraphs:
    """The brick engine's per-rank functions as `sharded.RankGraphs`. The
    brick engine has no migration branch, so nothing keys its graphs and
    no body counts one."""
    return RankGraphs(
        comm, lambda: (),
        lambda pos, vel, valid, pid, cell, active, with_click, tally: _local_step3d(
            pos, vel, valid, pid, cell, active, cfg, mcfg, comm, backend,
            with_click=with_click),
        lambda *state: _device_build3d(*state, cfg, mcfg, comm),
        lambda *rows: _device_update3d(*rows[:8], None, False, cfg, mcfg, comm, backend,
                                       with_click=rows[8]),
    )


def make_mesh3d_step(cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm,
                     backend: str = "kernels"):
    """`step(state, click_px=None, click_active=None) -> (DistState,
    DistAux)` for this rank's brick on `comm.device`, tpusph's jitted
    brick step (`tpusph/dist/mesh3d.py:544-585`); every rank of the grid
    calls it once a timestep. `kernels` (also under tpusph's names `auto`
    and `pallas`) runs the rank, density and force kernels on each rank;
    `cell_list` the plain-torch tile passes.

    On a card the step is CUDA-graph replays, one chain without a click
    and one with one (`sharded.RankGraphs`): one replay on a (1, 1, 1)
    grid, segments between the exchanges and the reduce with peers (the
    module docstring). `step.eager` is the same step as eager
    operations."""
    backend = _prepare3d(cfg, mcfg, comm, backend)

    def eager(state: DistState, click_px=None, click_active=None):
        """click_px: host pixel coordinates, the same on every rank, or
        None; without a click the kick is left out."""
        _check_device(state, comm)
        clicked = click_px is not None and (click_active is None or bool(click_active))
        cell = None
        if clicked:
            px, py = (int(v) for v in np.asarray(click_px))
            cell = click_cell_from_px(px, py, cfg)
        x, v, valid, pid, aux = _device_step3d(
            *state, cell, clicked, cfg, mcfg, comm, backend, with_click=clicked
        )
        return DistState(x, v, valid, pid), aux

    step = _rank_graphs3d(cfg, mcfg, comm, backend).step(cfg)
    step.eager = eager
    return step


def make_mesh3d_timed(cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm,
                      backend: str = "kernels"):
    """The brick step in two stages for the timed protocol, as
    `sharded.make_sharded_timed` (tpusph `dist/mesh3d.py:588-660`):

      build(state) -> (sorted rows, halo_ovf, oob, halo_send)
          the staged halo exchange and the sort ("grid construction")
      update(inter, halo_ovf, oob, halo_send) -> (DistState, DistAux)
          kernels, integration and migration ("SPH update"), without the
          click, as the reference's simulateAndTime runs the step

    The counters each stage returns are already reduced over the ranks.
    Returns (build, update): CUDA-graph replays each on a card (one on a
    (1, 1, 1) grid, segments with peers), what `build` returns the graph's
    own until the next `build` and `update` taking it. `build.eager` and
    `update.eager` are the eager stages."""
    backend = _prepare3d(cfg, mcfg, comm, backend)

    def build_eager(state: DistState):
        _check_device(state, comm)
        *inter, halo_ovf, oob, halo_send = _device_build3d(*state, cfg, mcfg, comm)
        (halo_ovf, oob), (halo_send,) = comm.reduce([halo_ovf, oob], [halo_send])
        return tuple(inter), halo_ovf, oob, halo_send

    def update_eager(inter, halo_ovf, oob, halo_send):
        x, v, valid, pid, (ovf_w, mig_ovf, misrouted, n_valid, mig_send) = _device_update3d(
            *inter, None, False, cfg, mcfg, comm, backend, with_click=False
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

    build, update = _rank_graphs3d(cfg, mcfg, comm, backend).timed()
    build.eager, update.eager = build_eager, update_eager
    return build, update


def make_mesh3d_run(cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm, steps: int,
                    backend: str = "kernels"):
    """`run(state) -> (DistState, DistAux)`: `steps` brick timesteps
    without a click, the production loop (tpusph `dist/mesh3d.py:672-730`),
    counters folded over the chain on the device as
    `sharded.make_sharded_run` folds them. On a card (`RankGraphs.run`) the
    chain is one CUDA-graph replay on a (1, 1, 1) grid, as tpusph's is one
    `lax.scan` dispatch; with peers one step's segments replayed `steps`
    times, the counters reduced after the last. `run.eager` is a Python
    loop of eager steps, which read nothing back between the steps."""
    backend = _prepare3d(cfg, mcfg, comm, backend)

    def eager(state: DistState):
        _check_device(state, comm)
        fields, auxs = tuple(state), []
        for _ in range(steps):
            *fields, aux = _device_step3d(
                *fields, None, False, cfg, mcfg, comm, backend, with_click=False
            )
            auxs.append(torch.stack(aux))
        auxs = torch.stack(auxs)  # [steps, 9], DistAux's order
        aux = DistAux(*auxs[:, :5].sum(dim=0), auxs[-1, 5], *auxs[:, 6:].amax(dim=0))
        return DistState(*fields), aux

    run = _rank_graphs3d(cfg, mcfg, comm, backend).run(steps)
    run.eager = eager
    return run


# ------------------------------------------------------------------- host IO
def brick_owner(pos: np.ndarray, cfg: SimConfig, mcfg: Mesh3DConfig) -> np.ndarray:
    """The owning rank of each position on the host, flat and (z, y,
    x)-major like `BrickComm`'s ranks: the mirror of the step's per-axis
    migration predicate (`_axis_migration`), cell space with explicit axis
    planes, float equal-width otherwise."""
    pos = np.asarray(pos)
    mz, my, mx = mcfg.mesh_shape

    def owner_of(col, ax_i, m):
        if mcfg.axis_planes is not None:
            cc = np.clip(
                (np.asarray(pos[:, col], np.float32) / np.float32(cfg.h)).astype(np.int32),
                0, cfg.num_cells_per_dim - 1,
            )
            interior = np.asarray(mcfg.axis_planes[ax_i][1:-1], np.int64)
            return np.searchsorted(interior, cc, side="right")
        w = cfg.box_dim / m
        return np.clip((pos[:, col] / w).astype(np.int64), 0, m - 1)

    # axes (z, y, x) ↔ position columns (2, 1, 0)
    return (owner_of(2, 0, mz) * my + owner_of(1, 1, my)) * mx + owner_of(0, 2, mx)


def balanced_brick_planes(pos: np.ndarray, cfg: SimConfig, mesh_shape) -> tuple:
    """Per-axis occupancy-quantile cell planes, (z, y, x) order as
    `Mesh3DConfig.axis_planes`: each axis split at its own marginal
    occupancy quantiles (`sharded.balanced_slab_planes`). Exact joint
    balance would need a partition that is not rectilinear; the marginals
    catch the structural skew (the dam-break lattice fills one corner)."""
    pos = np.asarray(pos)
    return tuple(
        balanced_slab_planes(pos[:, AXIS_DIM[ax]], cfg, mesh_shape[ax_i])
        for ax_i, ax in enumerate(AXES)
    )


def distribute_state_3d(state, cfg: SimConfig, mcfg: Mesh3DConfig, comm: BrickComm) -> DistState:
    """This rank's padded block of a whole state (a FluidState, or anything
    with position, velocity and valid), on `comm.device`. Every rank calls
    it with the same state and keeps the particles of its own brick; pid
    is the particle's row in `state`. A brick that holds more than
    `dev_capacity` particles raises on every rank."""
    pos, vel, valid = (
        np.asarray(torch.as_tensor(a).cpu()) for a in (state.position, state.velocity, state.valid)
    )
    c_dev = mcfg.dev_capacity
    owner = brick_owner(pos, cfg, mcfg)
    for dev, need in enumerate(np.bincount(owner[valid], minlength=math.prod(mcfg.mesh_shape))):
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
