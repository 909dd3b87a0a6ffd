"""Sort-based cell lists. Counterpart of `tpusph/neighbors/cell_list.py`.

  1. key[i] = x + C·y + C²·z (neighbors/grid.py); invalid slots carry the
     sentinel `num_cells`.
  2. A stable sort of the int32 keys gives `perm`: sorted[i] =
     original[perm[i]]. Stability makes `perm` equal to the JAX package's
     `argsort(stable=True)`.
  3. starts[k] = #particles with key < k, for k in [0, num_cells + 1], is
     the rank of k among the sorted keys, so the rank kernel answers all
     num_cells + 2 queries at once (`starts_from_sorted`); starts[num_cells
     + 1] == N. `starts_table` is the JAX package's histogram and cumsum,
     in plain torch, equal to it.

The 27-cell stencil is 9 contiguous windows of the sorted order: for
neighbour column (dy, dz) the candidates of a target with key k are the
flat keys [k+off−1, k+off+2), off = dy·C + dz·C², clipped to
[0, num_cells]. Keys wrap at the box edges; wrapped candidates are at least
(C−2)·h away and drop out at the r ≤ h cutoff.

`build_sorted_fields_1d` is the fields path's build: JAX's payload
`lax.sort` of (key, x, y, z, vx, vy, vz) becomes one stable `torch.sort` of
the keys and six 1-D `index_select`s, the same order because both sorts
are stable on the same keys.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.kernels.qrank import rank_queries
from tpusph_torch.neighbors.grid import compute_keys, compute_keys_fields


def starts_table(key: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """starts[k] = #particles with key < k as int32[num_cells + 2], by a
    histogram and an exclusive cumsum (the JAX package's `starts_table`).
    A scatter-add, not `bincount`, which reads the largest key on the host."""
    counts = key.new_zeros(cfg.num_cells + 1).index_add_(0, key.long(), torch.ones_like(key))
    starts = key.new_zeros(cfg.num_cells + 2)
    starts[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    return starts


@functools.cache
def cell_queries(num_cells: int, device: torch.device) -> torch.Tensor:
    """int32 0 .. num_cells + 1, the queries of the starts table. The same
    tensor for every call with (num_cells, device), so a step writes no
    4 MB of cell numbers; callers never write it."""
    return torch.arange(num_cells + 2, dtype=torch.int32, device=device)


def starts_from_sorted(key_sorted: torch.Tensor, cfg: SimConfig):
    """(starts int32[num_cells + 2], overflow) from the sorted keys: the rank
    of every cell among them, one launch of the rank kernel. The overflow is
    always 0: the rank kernel has no key window to overflow."""
    cells = cell_queries(cfg.num_cells, key_sorted.device)
    return rank_queries(key_sorted, cells, cfg.num_cells)


class CellList(NamedTuple):
    perm: torch.Tensor  # int64[Np], sorted[i] = original[perm[i]]
    key_sorted: torch.Tensor  # int32[Np]
    starts: torch.Tensor  # int32[num_cells + 2], exclusive prefix counts
    valid_sorted: torch.Tensor  # bool[Np]
    oob_count: torch.Tensor  # int64[] particles outside the grid
    starts_overflow: int  # always 0: the rank kernel has no window capacity


def build_cell_list(
    position: torch.Tensor, valid: torch.Tensor, cfg: SimConfig, histogram: bool = False
) -> CellList:
    """One sort and one rank pass (kernelBuildGrid + kernelResetGrid).
    `histogram=True` takes the starts from `starts_table` instead of the
    rank kernel: the `cell_list` backend's build, plain torch throughout
    like the JAX package's."""
    keys = compute_keys(position, valid, cfg)
    key_sorted, perm = torch.sort(keys.key, stable=True)
    if histogram:
        starts, overflow = starts_table(keys.key, cfg), 0
    else:
        starts, overflow = starts_from_sorted(key_sorted, cfg)
    return CellList(
        perm=perm,
        key_sorted=key_sorted,
        starts=starts,
        valid_sorted=key_sorted < cfg.num_cells,
        oob_count=keys.oob_count,
        starts_overflow=overflow,
    )


class SortedFields(NamedTuple):
    """Cell-sorted particle fields as 1-D rows, the fields path's build."""

    key_sorted: torch.Tensor  # int32[Np]
    x: torch.Tensor  # f32[Np]
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    starts: torch.Tensor  # int32[num_cells + 2]
    valid_sorted: torch.Tensor  # bool[Np]
    oob_count: torch.Tensor  # int64[]
    starts_overflow: int  # always 0, as in CellList


def build_sorted_fields_1d(x, y, z, vx, vy, vz, valid, cfg: SimConfig) -> SortedFields:
    """Keys, one stable sort, the six rows gathered into sorted order, and
    the starts table from the rank kernel."""
    key, oob_count = compute_keys_fields(x, y, z, valid, cfg)
    key_sorted, perm = torch.sort(key, stable=True)
    rows = [a.index_select(0, perm) for a in (x, y, z, vx, vy, vz)]
    starts, overflow = starts_from_sorted(key_sorted, cfg)
    return SortedFields(
        key_sorted, *rows,
        starts=starts,
        valid_sorted=key_sorted < cfg.num_cells,
        oob_count=oob_count,
        starts_overflow=overflow,
    )
