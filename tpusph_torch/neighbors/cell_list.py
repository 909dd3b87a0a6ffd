"""Sort-based cell lists. Counterpart of `tpusph/neighbors/cell_list.py`.

  1. key[i] = x + C·y + C²·z (neighbors/grid.py); invalid slots carry the
     sentinel `num_cells`.
  2. A stable sort of the int32 keys gives `perm`: sorted[i] =
     original[perm[i]]. Stability makes `perm` equal to the JAX package's
     `argsort(stable=True)`.
  3. starts[k] = #particles with key < k, for k in [0, num_cells + 1], is
     the rank of k among the sorted keys, so the rank kernel answers all
     num_cells + 2 queries at once. This replaces the JAX package's
     histogram (`starts_table`); starts[num_cells + 1] == N.

The 27-cell stencil is 9 contiguous windows of the sorted order: for
neighbour column (dy, dz) the candidates of a target with key k are the
flat keys [k+off−1, k+off+2), off = dy·C + dz·C², clipped to
[0, num_cells]. Keys wrap at the box edges; wrapped candidates are at least
(C−2)·h away and drop out at the r ≤ h cutoff.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusph_torch.core.config import SimConfig
from tpusph_torch.kernels.qrank import rank_queries
from tpusph_torch.neighbors.grid import compute_keys


class CellList(NamedTuple):
    perm: torch.Tensor  # int64[Np], sorted[i] = original[perm[i]]
    key_sorted: torch.Tensor  # int32[Np]
    starts: torch.Tensor  # int32[num_cells + 2], exclusive prefix counts
    valid_sorted: torch.Tensor  # bool[Np]
    oob_count: torch.Tensor  # int64[] particles outside the grid
    starts_overflow: int  # always 0: the rank kernel has no window capacity


def build_cell_list(
    position: torch.Tensor, valid: torch.Tensor, cfg: SimConfig
) -> CellList:
    """One sort and one rank pass (kernelBuildGrid + kernelResetGrid)."""
    keys = compute_keys(position, valid, cfg)
    key_sorted, perm = torch.sort(keys.key, stable=True)
    cells = torch.arange(cfg.num_cells + 2, dtype=torch.int32, device=position.device)
    starts, overflow = rank_queries(key_sorted, cells, cfg.num_cells)
    return CellList(
        perm=perm,
        key_sorted=key_sorted,
        starts=starts,
        valid_sorted=key_sorted < cfg.num_cells,
        oob_count=keys.oob_count,
        starts_overflow=overflow,
    )
