"""One SPH timestep (kernelBuildGrid → kernelUpdatePressureAndDensity →
kernelUpdateForces → kernelUpdatePositions, simulator.cu:462-497).
Counterpart of `tpusph/engine/step.py`.

Backends with the same physics:
  * step_allpairs  — O(N²) oracle (tests, small N).
  * step_cell_list — sort, the histogram starts table, then the JAX
    package's tile passes (`_density_pass_sorted`, `_force_pass_sorted`) in
    plain torch, with a fixed candidate capacity per tile whose overflow is
    counted. No kernel: in tpusph these are XLA code, not Pallas.
  * step_kernels   — sort, starts table from the rank kernel, then the
    density and force kernels over the sorted order, scattered back to the
    caller's particle order. The counterpart of `step_pallas`.

The fields path, the counterpart of `step_pallas_fields`: `FieldsState`
carries 1-D rows across steps, `step_kernels_fields` sorts them, runs the
three kernels and integrates per axis with no (N, 3) gather or scatter,
and returns the state in sorted order. `make_fields_chain` chains it as
bench.py's `lax.scan` does, as one CUDA-graph replay on a card.

`make_step` is the entry point, tpusph's jitted step: one CUDA-graph
replay a call on a card (`engine/graphs.py`). The steps are functional:
they return a new state and leave their input as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.state import FIELDS, FluidState
from tpusph_torch.engine.graphs import GraphedLoop
from tpusph_torch.kernels.fused import column_offsets, density, force
from tpusph_torch.neighbors.allpairs import density_allpairs, forces_allpairs
from tpusph_torch.neighbors.cell_list import (
    CellList,
    SortedFields,
    build_cell_list,
    build_sorted_fields_1d,
)
from tpusph_torch.physics.integrate import integrate, integrate_fields
from tpusph_torch.physics.kernels import pair_density, pair_force, pressure_from_density
from tpusph_torch.utils.chunking import pick_chunk


class StepAux(NamedTuple):
    """Per-step diagnostics."""

    oob_count: torch.Tensor | int  # particles outside the grid
    # Candidates beyond a window capacity: an int32 device tensor from the
    # tile passes of `step_cell_list`; the int 0 from the kernels, which
    # walk every window to its end (the rank kernel has no window either).
    window_overflow: torch.Tensor | int


def _finish(state: FluidState, force_, density_, pressure, cfg: SimConfig,
            out: FluidState | None = None) -> FluidState:
    """Integrate valid particles; freeze invalid padding slots. `out`: the
    position and velocity are written into its tensors."""
    x, v = integrate(state.position, state.velocity, force_, density_, cfg)
    valid3 = state.valid[:, None]
    return FluidState(
        position=torch.where(valid3, x, state.position,
                             out=None if out is None else out.position),
        velocity=torch.where(valid3, v, state.velocity,
                             out=None if out is None else out.velocity),
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


def build_phase(state: FluidState, cfg: SimConfig, histogram: bool = False) -> CellList:
    """Neighbour-structure build, the timed "grid construction" phase
    (kernelBuildGrid, simulator.cu:505-513). `histogram` as in
    `build_cell_list`."""
    return build_cell_list(state.position, state.valid, cfg, histogram)


def masked_pressure(raw, valid_s, cfg: SimConfig):
    """(density, pressure) of sorted rows from the raw density sums; the
    invalid rows get density 1 and pressure 0."""
    rho_s, p_s = pressure_from_density(raw, cfg)
    return torch.where(valid_s, rho_s, 1.0), torch.where(valid_s, p_s, 0.0)


# ------------------------------------------------------------ tile passes


def _tile_shape(n: int, cfg: SimConfig) -> tuple[int, int]:
    """(tile_size, candidate_capacity) with tile_size dividing n."""
    return pick_chunk(n, cfg.tile_size), cfg.tile_cand_capacity


def _tile_ranges(tkey, tvalid, offset: int, starts, cfg: SimConfig, cap: int):
    """Per tile of a batch (tkey, tvalid [B, t]): the contiguous sorted range
    holding every candidate at flat-key offset `offset` of every valid
    target, keys [kmin−1+off, kmax+2+off). Returns (start, cnt, full_cnt),
    int32[B] each; cnt is full_cnt cut at `cap`."""
    nc = cfg.num_cells
    kmin = torch.where(tvalid, tkey, nc).amin(dim=1)
    kmax = torch.where(tvalid, tkey, -1).amax(dim=1)
    lo = (kmin + (offset - 1)).clamp(0, nc)
    hi = torch.maximum((kmax + (offset + 2)).clamp(max=nc), lo)
    start = starts[lo.long()]
    full = starts[hi.long()] - start
    return start, full.clamp(max=cap), full


PAIRS_PER_BATCH = 1 << 22  # target-candidate pairs per batch of tiles


def _tile_batches(n: int, t: int, cap: int):
    """Slices of whole tiles with at most PAIRS_PER_BATCH (target,
    candidate) pairs each, at least one tile: the `lax.map` over tiles in
    batches, so the [B, t, cap] temporaries stay bounded (~50 MB a
    3-vector) whatever n is."""
    step = max(1, PAIRS_PER_BATCH // (t * cap)) * t
    return [slice(a, min(n, a + step)) for a in range(0, n, step)]


def _window(tkey, tvalid, off, starts, key_pad, lane, cfg, cap):
    """(rows int64[B, cap], hit bool[B, t, cap], excess int32[B]) of one
    column for a batch of tiles: the cap rows from each tile's range
    start, and the pairs the key-difference mask assigns to this column."""
    start, cnt, full = _tile_ranges(tkey, tvalid, off, starts, cfg, cap)
    rows = start.long()[:, None] + lane
    diff = key_pad[rows][:, None, :] - tkey[:, :, None]
    hit = (diff >= off - 1) & (diff <= off + 1) & (lane < cnt[:, None])[:, None, :]
    return rows, hit, (full - cap).clamp(min=0)


def _density_pass_sorted(sp, key_s, valid_s, starts, cfg: SimConfig):
    """Density and pressure of sorted targets (kernelUpdatePressureAndDensity,
    simulator.cu:149-190) in the tile formulation: each tile's 9 columns
    are contiguous ranges shared by its targets. Returns (rho, p,
    overflow int32[])."""
    n = sp.shape[0]
    t, cap = _tile_shape(n, cfg)
    sp_pad = torch.cat([sp, sp.new_zeros((cap, 3))])
    key_pad = torch.cat([key_s, key_s.new_full((cap,), 2**30)])
    lane = torch.arange(cap, device=sp.device)
    rho = sp.new_empty(n)
    ovf = torch.zeros((), dtype=torch.int32, device=sp.device)
    for b in _tile_batches(n, t, cap):
        tpos = sp[b].reshape(-1, t, 3)
        tkey, tvalid = key_s[b].reshape(-1, t), valid_s[b].reshape(-1, t)
        acc = sp.new_zeros(tkey.shape)
        for off in column_offsets(cfg):
            rows, hit, excess = _window(tkey, tvalid, off, starts, key_pad, lane, cfg, cap)
            disp = tpos[:, :, None, :] - sp_pad[rows][:, None, :, :]
            acc += torch.where(hit, pair_density(disp, cfg), 0.0).sum(dim=2)
            ovf += excess.sum()
        rho[b] = acc.reshape(-1)
    return (*masked_pressure(rho, valid_s, cfg), ovf)


def _force_pass_sorted(sp, sv, rho_s, p_s, key_s, valid_s, starts, cfg: SimConfig):
    """Pressure and viscosity forces on sorted targets (kernelUpdateForces,
    simulator.cu:192-256), tile formulation. Candidate fields are packed as
    f32[n + cap, 8] (x, v, ρ, p; padding ρ = 1) so a column is one gather."""
    n = sp.shape[0]
    t, cap = _tile_shape(n, cfg)
    pad = sp.new_zeros((cap, 8))
    pad[:, 6] = 1.0
    packed = torch.cat([torch.cat([sp, sv, rho_s[:, None], p_s[:, None]], dim=1), pad])
    key_pad = torch.cat([key_s, key_s.new_full((cap,), 2**30)])
    lane = torch.arange(cap, device=sp.device)
    f = sp.new_empty((n, 3))
    for b in _tile_batches(n, t, cap):
        tpos, tvel = sp[b].reshape(-1, t, 3), sv[b].reshape(-1, t, 3)
        tp = p_s[b].reshape(-1, t)
        tkey, tvalid = key_s[b].reshape(-1, t), valid_s[b].reshape(-1, t)
        acc = sp.new_zeros(tpos.shape)
        for off in column_offsets(cfg):
            rows, hit, _ = _window(tkey, tvalid, off, starts, key_pad, lane, cfg, cap)
            cand = packed[rows][:, None]  # [B, 1, cap, 8]
            disp = tpos[:, :, None, :] - cand[..., :3]
            dv = cand[..., 3:6] - tvel[:, :, None, :]
            fij = pair_force(disp, dv, tp[:, :, None], cand[..., 7], cand[..., 6], cfg)
            acc += torch.where(hit[..., None], fij, 0.0).sum(dim=2)
        f[b] = torch.where(tvalid[..., None], acc, 0.0).reshape(-1, 3)
    return f


def update_phase(state: FluidState, cl: CellList, cfg: SimConfig,
                 out: FluidState | None = None):
    """Density → forces → integrate on the tile passes, the `cell_list`
    backend's "SPH update" phase (simulator.cu:516-529). Returns (new_state,
    aux); aux.window_overflow is an int32 device tensor. `out`: the new
    state is written into its tensors but `valid`, which is `state`'s."""
    sp = state.position[cl.perm]
    sv = state.velocity[cl.perm]
    rho_s, p_s, ovf = _density_pass_sorted(sp, cl.key_sorted, cl.valid_sorted, cl.starts, cfg)
    f_s = _force_pass_sorted(
        sp, sv, rho_s, p_s, cl.key_sorted, cl.valid_sorted, cl.starts, cfg
    )
    new_state = _finish(state, *_scatter_back(state, cl, f_s, rho_s, p_s, out), cfg, out)
    return new_state, StepAux(oob_count=cl.oob_count, window_overflow=ovf + cl.starts_overflow)


def step_cell_list(state: FluidState, cfg: SimConfig):
    """Timestep on the tile passes: sort → histogram starts → tile density
    and force → integrate → scatter back to the caller's particle order."""
    return update_phase(state, build_phase(state, cfg, histogram=True), cfg)


def _scatter_back(state: FluidState, cl: CellList, f_s, rho_s, p_s,
                  out: FluidState | None = None):
    """(force, density, pressure) in the caller's particle order: sorted[i]
    is original[perm[i]]; into `out`'s tensors where given."""
    n = state.num_slots
    force_, density_, pressure = (
        (f_s.new_empty((n, 3)), rho_s.new_empty(n), p_s.new_empty(n)) if out is None
        else (out.force, out.density, out.pressure))
    return (
        force_.index_copy_(0, cl.perm, f_s),
        density_.index_copy_(0, cl.perm, rho_s),
        pressure.index_copy_(0, cl.perm, p_s),
    )


def update_phase_kernels(state: FluidState, cl: CellList, cfg: SimConfig,
                         out: FluidState | None = None, walk: torch.Tensor | None = None):
    """Density → forces → integrate, the timed "SPH update" phase
    (simulator.cu:516-529), on the density and force kernels. Returns
    (new_state, aux); `out` as in `update_phase`. `walk`: the force pass's
    walk counter (`kernels.fused.force`), None to count nothing."""
    xyz = state.position[cl.perm].T.contiguous()  # (3, n) sorted rows
    vxyz = state.velocity[cl.perm].T.contiguous()
    valid_s = cl.valid_sorted
    raw = density(*xyz, cl.key_sorted, cl.starts, cfg)
    rho_s, p_s = masked_pressure(raw, valid_s, cfg)
    f_s = force(*xyz, *vxyz, rho_s, p_s, cl.key_sorted, cl.starts, cfg, walk=walk)
    f_s = torch.where(valid_s, f_s, 0.0).T
    new_state = _finish(state, *_scatter_back(state, cl, f_s, rho_s, p_s, out), cfg, out)
    aux = StepAux(oob_count=cl.oob_count, window_overflow=cl.starts_overflow)
    return new_state, aux


def step_kernels(state: FluidState, cfg: SimConfig):
    """Production timestep: build, then update on the kernels."""
    return update_phase_kernels(state, build_phase(state, cfg), cfg)


# ------------------------------------------------------------- fields path


class FieldsState(NamedTuple):
    """Hot-loop state as 1-D rows, the layout the fields step carries across
    chained steps; `fields_from_state` makes one at the loop's start."""

    x: torch.Tensor  # f32[N]
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    valid: torch.Tensor  # bool[N]


def fields_from_state(state: FluidState) -> FieldsState:
    p, v = state.position, state.velocity
    return FieldsState(
        *(a[:, i].contiguous() for a in (p, v) for i in range(3)), state.valid
    )


def state_from_fields(fs: FieldsState, density=None, pressure=None) -> FluidState:
    """The FluidState of a fields state at the loop's end: zero force,
    density 1 and pressure 0 unless given."""
    n = fs.x.shape[0]
    return FluidState(
        position=torch.stack([fs.x, fs.y, fs.z], dim=1),
        velocity=torch.stack([fs.vx, fs.vy, fs.vz], dim=1),
        force=fs.x.new_zeros((n, 3)),
        density=density if density is not None else fs.x.new_ones(n),
        pressure=pressure if pressure is not None else fs.x.new_zeros(n),
        valid=fs.valid,
    )


def masked_force(sf: SortedFields, rho_s, p_s, cfg: SimConfig):
    """(fx, fy, fz) of the sorted rows from the force kernel; 0 on the
    invalid rows."""
    f_rows = force(sf.x, sf.y, sf.z, sf.vx, sf.vy, sf.vz, rho_s, p_s, sf.key_sorted, sf.starts,
                   cfg)
    return tuple(torch.where(sf.valid_sorted, f_rows[a], 0.0) for a in range(3))


def masked_integrate(sf: SortedFields, fxyz, rho_s, cfg: SimConfig) -> FieldsState:
    """The sorted rows moved by one integration step; the invalid rows
    stay where they are."""
    xyz, vxyz = (sf.x, sf.y, sf.z), (sf.vx, sf.vy, sf.vz)
    moved = integrate_fields(*xyz, *vxyz, *fxyz, rho_s, cfg)
    return FieldsState(
        *(torch.where(sf.valid_sorted, a, b) for a, b in zip(moved, (*xyz, *vxyz))),
        sf.valid_sorted,
    )


def step_kernels_fields(fs: FieldsState, cfg: SimConfig):
    """Fields-native timestep on the rank, density and force kernels,
    returning the state in SORTED order (the physics is permutation-
    invariant; `valid` travels with the particles). Returns
    ((FieldsState, rho_s, p_s, (fx, fy, fz)), aux)."""
    sf = build_sorted_fields_1d(*fs, cfg)
    raw = density(sf.x, sf.y, sf.z, sf.key_sorted, sf.starts, cfg)
    rho_s, p_s = masked_pressure(raw, sf.valid_sorted, cfg)
    fxyz = masked_force(sf, rho_s, p_s, cfg)
    out = masked_integrate(sf, fxyz, rho_s, cfg)
    aux = StepAux(oob_count=sf.oob_count, window_overflow=sf.starts_overflow)
    return (out, rho_s, p_s, fxyz), aux


def make_fields_chain(cfg: SimConfig, steps: int, device):
    """`FieldsState -> (FieldsState, summed overflow int32[])`: `steps`
    fields steps chained, bench.py's `lax.scan` loop (bench.py:438-450).
    On a card the chain is one CUDA-graph replay, captured at the first
    call (`engine/graphs.py`); on the CPU the same loop runs eagerly. Call
    with FieldsStates of cfg.padded_num_particles rows on `device`."""
    cfg.validate()
    device = torch.device(device)

    def chain(rows: list) -> list:
        fs = FieldsState(*rows)
        ovf = torch.zeros((), dtype=torch.int32, device=fs.x.device)
        for _ in range(steps):
            (fs, _, _, _), aux = step_kernels_fields(fs, cfg)
            ovf = ovf + aux.window_overflow
        return [*fs, ovf]

    loop = GraphedLoop(chain, device)

    def run(fs: FieldsState):
        if fs.x.device.type != device.type:
            raise ValueError(f"state is on {fs.x.device}, chain was made for {device}")
        *rows, ovf = loop(list(fs))
        return FieldsState(*rows), ovf

    return run


BACKENDS = {
    "allpairs": step_allpairs,
    "cell_list": step_cell_list,
    "kernels": step_kernels,
}
# tpusph's names for its kernel backend: `auto` is its default, `pallas` the
# Pallas kernels that the CUDA kernels replace
BACKEND_ALIASES = {"auto": "kernels", "pallas": "kernels"}


def resolve_backend(name: str) -> str:
    """The key of BACKENDS that `name` stands for (tpusph's `auto` and
    `pallas` are `kernels`); a ValueError that lists the names otherwise."""
    key = BACKEND_ALIASES.get(name, name)
    if key not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}: expected one of "
            f"{sorted([*BACKENDS, *BACKEND_ALIASES])}"
        )
    return key


def make_step(cfg: SimConfig, backend: str = "kernels", device="cuda"):
    """`state -> (state, aux)` for states on `device`, the counterpart of
    tpusph's jitted step (`tpusph/engine/step.py:380`). On a card the step
    is one CUDA-graph replay per backend (`engine/graphs.py`), captured at
    the first call after the kernels are built here; every backend
    captures (`allpairs` too: its row chunks read nothing from the host).
    On the CPU the same body runs under the capture guard. `step.eager`
    is the same step as a stream of eager operations."""
    cfg.validate()
    fn = BACKENDS[resolve_backend(backend)]
    device = torch.device(device)
    if device.type == "cuda":
        from tpusph_torch.utils import cuda_build

        cuda_build.library()

    def body(fields: list) -> list:
        new, aux = fn(FluidState(*fields), cfg)
        return [*(getattr(new, f) for f in FIELDS), *aux]

    loop = GraphedLoop(body, device)

    def check(state: FluidState):
        if state.device.type != device.type:
            raise ValueError(f"state is on {state.device}, step was made for {device}")

    def step(state: FluidState):
        check(state)
        *fields, oob, ovf = loop([getattr(state, f) for f in FIELDS])
        return FluidState(*fields), StepAux(oob_count=oob, window_overflow=ovf)

    def eager(state: FluidState):
        check(state)
        return fn(state, cfg)

    step.eager = eager
    return step
