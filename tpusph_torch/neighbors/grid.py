"""Uniform-grid cell keys (getGridCell / flattenGridCoord,
simulator.cu:57-82). Counterpart of `tpusph/neighbors/grid.py`.

cell = (int)(position / h) per axis, truncating; the flat key is
x + C·y + C²·z, row-major with x fastest, so after a sort the three
x-adjacent cells of any (y, z) column are contiguous. Valid particles
outside [0, C)³ are counted and clamped into the grid; invalid slots get
the sentinel key `num_cells`.

The division is a true float32 division by a float32 `h` held in a
tensor on the particles' device. Dividing by a python float would let
PyTorch's CUDA path multiply by the reciprocal instead, which moves some
keys across a cell edge. That tensor is one constant per (cfg, device),
made at its first use, so a step captured in a CUDA graph after a
warm-up step makes no copy from the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig, f32


@functools.cache
def h_tensor(cfg: SimConfig, device: torch.device) -> torch.Tensor:
    """float32 `h` as a 0-d tensor on `device`, the cell-key divisor. The
    same tensor for every call with (cfg, device); callers never write it."""
    return torch.full((), f32(cfg.h), dtype=torch.float32, device=device)


def cell_coords(position: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """f32[..., 3] → int32[..., 3], truncated like the reference's cast."""
    return (position / h_tensor(cfg, position.device)).to(torch.int32)


class GridKeys(NamedTuple):
    key: torch.Tensor  # int32[N] flat cell key; num_cells for invalid slots
    cell: torch.Tensor  # int32[N, 3] clamped cell coords
    oob_count: torch.Tensor  # int64[] valid particles outside [0, C)³


def flatten_rowmajor(cell: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """int[..., 3] cell coordinates → the flat key x + C·y + C²·z."""
    c = cfg.num_cells_per_dim
    return cell[..., 0] + c * cell[..., 1] + (c * c) * cell[..., 2]


def _flat_key(cx, cy, cz, valid, cfg: SimConfig):
    """flatten_rowmajor of the clamped cell on field rows, the sentinel for
    invalid slots."""
    c = cfg.num_cells_per_dim
    key = cx.clamp(0, c - 1) + c * cy.clamp(0, c - 1) + (c * c) * cz.clamp(0, c - 1)
    return torch.where(valid, key, cfg.num_cells).to(torch.int32)


def compute_keys(position: torch.Tensor, valid: torch.Tensor, cfg: SimConfig) -> GridKeys:
    """Cell keys of every particle slot."""
    c = cfg.num_cells_per_dim
    raw = cell_coords(position, cfg)
    oob = torch.any((raw < 0) | (raw >= c), dim=-1)
    cell = raw.clamp(0, c - 1)
    key = torch.where(valid, flatten_rowmajor(cell, cfg), cfg.num_cells).to(torch.int32)
    return GridKeys(key=key, cell=cell, oob_count=(oob & valid).sum())


def compute_keys_fields(x, y, z, valid, cfg: SimConfig):
    """compute_keys on 1-D field rows. Returns (key int32[N], oob_count)."""
    c = cfg.num_cells_per_dim
    h = h_tensor(cfg, x.device)
    cx, cy, cz = ((a / h).to(torch.int32) for a in (x, y, z))
    oob = (cx < 0) | (cx >= c) | (cy < 0) | (cy >= c) | (cz < 0) | (cz >= c)
    return _flat_key(cx, cy, cz, valid, cfg), (oob & valid).sum()
