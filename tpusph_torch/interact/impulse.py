"""Click-ripple impulse (kernelMoveParticles, simulator.cu:329-367).
Counterpart of `tpusph/interact/impulse.py`, with the same semantics:

  * pixel → world: x = (px − BOX_MIN_X)/(BOX_MAX_X − BOX_MIN_X)·box_dim, the
    same for y, in float32 on the host (cu:331-336);
  * click cell by truncation, then the y-flip cell.y = C − cell.y (cu:340);
  * a particle in cell (px, py, pz) is kicked when |px − cx| ≤ 2 and
    |py − cy| ≤ 2: v.x += PUSH/dx and v.y += PUSH/dy for nonzero dx, dy,
    and the centre column gets v.z −= PUSH (cu:342-366);
  * each kick is scaled by the number of the reference's z-slab threads
    that land on the particle's z cell (`_slab_multiplicity`), the value
    the reference's racing `+=` nominally computes.

The impulse runs after integration with cells from the pre-step
positions, the reference's order (cu:482-489). Particle cells divide by a
float32 `h` held in a tensor on the particles' device: a python-float
divisor lets PyTorch's CUDA path multiply by the reciprocal, which moves
particles on a cell boundary into the next cell.

The kick can be captured in a CUDA graph: the click cell may be a device
int32[2] tensor, and `h` (`grid.h_tensor`), the push and the
multiplicity table are made once per (cfg, device) at the first kick,
which the warm-up before a capture runs. `apply_kick` gates the kick with a
device int32 gain, `torch.where(gain > 0, v + kick, v)`: with gain 0 the
velocity is left bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch.core.config import (
    BOX_MAX_X,
    BOX_MAX_Y,
    BOX_MIN_X,
    BOX_MIN_Y,
    PUSH_STRENGTH,
    SimConfig,
    f32,
)
from tpusph_torch.core.state import FluidState
from tpusph_torch.engine.graphs import GraphedLoop
from tpusph_torch.neighbors.grid import h_tensor


def click_in_box(px: int, py: int) -> bool:
    """Pixel-bounds gate, as in the mouse() callback (display.cpp:24-27)."""
    return BOX_MIN_X <= px < BOX_MAX_X and BOX_MIN_Y <= py < BOX_MAX_Y


def _slab_multiplicity(cfg: SimConfig, device="cpu") -> torch.Tensor:
    """count[cz] = #slabs t ∈ [0, C) with (int)((t·h)/h) == cz, in float32
    like the reference's per-thread z (cu:337, 57-59). int32[C]."""
    c = cfg.num_cells_per_dim
    h = torch.tensor(f32(cfg.h), dtype=torch.float32)
    cz = (torch.arange(c, dtype=torch.float32) * h / h).to(torch.int32).clamp(0, c - 1)
    count = torch.zeros(c, dtype=torch.int32).index_add_(
        0, cz, torch.ones(c, dtype=torch.int32)
    )
    return count.to(device)


class _KickConstants(NamedTuple):
    push: torch.Tensor  # f32[] PUSH_STRENGTH, a tensor so push / dx divides
    mult: torch.Tensor  # f32[C] slab multiplicity


@functools.cache
def _kick_constants(cfg: SimConfig, device: torch.device) -> _KickConstants:
    """The kick's constants on `device`, made once per (cfg, device); the
    kick reads them and never writes them."""
    return _KickConstants(
        push=torch.full((), PUSH_STRENGTH, dtype=torch.float32, device=device),
        mult=_slab_multiplicity(cfg, device).to(torch.float32),
    )


def click_cell_from_px(px: int, py: int, cfg: SimConfig) -> tuple[int, int]:
    """Pixel → (cell_x, cell_y flipped) on the host in numpy float32, IEEE
    division as in the reference's device math (cu:331-340). A click can
    land on a cell boundary (pixel 400 → x = 5.0, 5.0/0.1f = 49.99999925)."""
    F = np.float32
    x = (F(px) - F(BOX_MIN_X)) / F(BOX_MAX_X - BOX_MIN_X) * F(cfg.box_dim)
    y = (F(py) - F(BOX_MIN_Y)) / F(BOX_MAX_Y - BOX_MIN_Y) * F(cfg.box_dim)
    cx = int(x / F(cfg.h))
    cy = cfg.num_cells_per_dim - int(y / F(cfg.h))  # y-flip (cu:340)
    return cx, cy


def click_kick_fields(x, y, z, valid, click_cell, cfg: SimConfig):
    """Velocity-delta rows (kx, ky, kz), f32[N] each, for a click at grid
    cell `click_cell` (two ints from click_cell_from_px, or a device int32[2]
    tensor), from the cells of the field rows x, y, z."""
    c = cfg.num_cells_per_dim
    k = _kick_constants(cfg, x.device)
    h = h_tensor(cfg, x.device)
    ccx, ccy = click_cell[0], click_cell[1]

    pcx, pcy, pcz = ((a / h).to(torch.int32).clamp(0, c - 1) for a in (x, y, z))
    dx = pcx - ccx
    dy = pcy - ccy
    m = k.mult[pcz.long()]

    hit = (dx.abs() <= 2) & (dy.abs() <= 2) & valid
    fdx = dx.to(torch.float32)
    fdy = dy.to(torch.float32)
    kick_x = torch.where(dx != 0, k.push / torch.where(dx != 0, fdx, 1.0), 0.0)
    kick_y = torch.where(dy != 0, k.push / torch.where(dy != 0, fdy, 1.0), 0.0)
    kick_z = torch.where((dx == 0) & (dy == 0), -k.push, 0.0)
    return (
        torch.where(hit, kick_x * m, 0.0),
        torch.where(hit, kick_y * m, 0.0),
        torch.where(hit, kick_z * m, 0.0),
    )


def click_kick(pre_step_position, valid, click_cell, cfg: SimConfig):
    """Velocity delta f32[N, 3] for a click at grid cell `click_cell`, from
    the pre-step cells; the (N, 3) form of click_kick_fields."""
    kx, ky, kz = click_kick_fields(
        pre_step_position[:, 0], pre_step_position[:, 1], pre_step_position[:, 2],
        valid, click_cell, cfg,
    )
    return torch.stack([kx, ky, kz], dim=-1)


def apply_kick(velocity, pre_step_position, valid, click_cell, gain, cfg: SimConfig):
    """velocity + the kick of a click at `click_cell` where the int32 `gain`
    is > 0, `velocity` itself where it is 0; no host read, so a chunk
    captured in a CUDA graph takes its clicks as device tensors."""
    kick = click_kick(pre_step_position, valid, click_cell, cfg)
    return torch.where(gain > 0, velocity + kick, velocity)


def apply_click_impulse(state: FluidState, pre_step_position, click_px, cfg: SimConfig) -> FluidState:
    """`state` with the kick of a click at host pixel coordinates
    `click_px` added to its velocities, cells from `pre_step_position`;
    the pixel → cell conversion on the host (click_cell_from_px)."""
    px, py = (int(v) for v in np.asarray(click_px))
    kick = click_kick(pre_step_position, state.valid, click_cell_from_px(px, py, cfg), cfg)
    return dataclasses.replace(state, velocity=state.velocity + kick)


def make_impulse(cfg: SimConfig):
    """`(state, pre_pos, click_px) -> state`, the counterpart of tpusph's
    jitted impulse (`tpusph/interact/impulse.py:152`): the pixel → cell
    conversion on the host, then the kick on the state's device, one
    CUDA-graph replay on a card (`apply_kick` under the capture guard on
    the CPU), the click cell and its gain going in as int32 tensors as
    tpusph traces its int32[2]. `impulse.eager` is `apply_click_impulse`."""
    one = torch.ones((), dtype=torch.int32)
    loops: dict = {}  # device → GraphedLoop

    def body(inputs: list) -> list:
        velocity, pre_pos, valid, cell, gain = inputs
        return [apply_kick(velocity, pre_pos, valid, cell, gain, cfg)]

    def impulse(state: FluidState, pre_pos, click_px) -> FluidState:
        px, py = (int(v) for v in np.asarray(click_px))
        cell = torch.tensor(click_cell_from_px(px, py, cfg), dtype=torch.int32)
        if state.device not in loops:
            loops[state.device] = GraphedLoop(body, state.device)
        (velocity,) = loops[state.device]([state.velocity, pre_pos, state.valid, cell, one])
        return dataclasses.replace(state, velocity=velocity)

    def eager(state: FluidState, pre_pos, click_px) -> FluidState:
        return apply_click_impulse(state, pre_pos, click_px, cfg)

    impulse.eager = eager
    return impulse
