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
keys across a cell edge.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig, f32


def cell_coords(position: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """f32[..., 3] → int32[..., 3], truncated like the reference's cast."""
    h = torch.tensor(f32(cfg.h), dtype=torch.float32, device=position.device)
    return (position / h).to(torch.int32)


class GridKeys(NamedTuple):
    key: torch.Tensor  # int32[N] flat cell key; num_cells for invalid slots
    cell: torch.Tensor  # int32[N, 3] clamped cell coords
    oob_count: torch.Tensor  # int64[] valid particles outside [0, C)³


def _flat_key(cx, cy, cz, valid, cfg: SimConfig):
    c = cfg.num_cells_per_dim
    key = cx.clamp(0, c - 1) + c * cy.clamp(0, c - 1) + (c * c) * cz.clamp(0, c - 1)
    return torch.where(valid, key, cfg.num_cells).to(torch.int32)


def compute_keys(position: torch.Tensor, valid: torch.Tensor, cfg: SimConfig) -> GridKeys:
    """Cell keys of every particle slot."""
    c = cfg.num_cells_per_dim
    raw = cell_coords(position, cfg)
    oob = torch.any((raw < 0) | (raw >= c), dim=-1)
    key = _flat_key(raw[:, 0], raw[:, 1], raw[:, 2], valid, cfg)
    return GridKeys(key=key, cell=raw.clamp(0, c - 1), oob_count=(oob & valid).sum())


def compute_keys_fields(x, y, z, valid, cfg: SimConfig):
    """compute_keys on 1-D field rows. Returns (key int32[N], oob_count)."""
    c = cfg.num_cells_per_dim
    h = torch.tensor(f32(cfg.h), dtype=torch.float32, device=x.device)
    cx, cy, cz = ((a / h).to(torch.int32) for a in (x, y, z))
    oob = (cx < 0) | (cx >= c) | (cy < 0) | (cy >= c) | (cz < 0) | (cz >= c)
    return _flat_key(cx, cy, cz, valid, cfg), (oob & valid).sum()
