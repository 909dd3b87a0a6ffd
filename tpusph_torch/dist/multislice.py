"""The multi-slice topology of the z-slab line. Counterpart of
`tpusph/dist/multislice.py`.

On a TPU pod, a slice is a block of devices joined by ICI, and slices are
joined only by the slower data-centre network (DCN). The z-slab step talks
only to its two neighbours on the line (the halo round and migration; no
other collective in the step), so the traffic that crosses a slice boundary
is exactly the slab faces that lie on one, provided the line is ordered
slice-major. Here a slice is a group of ranks, by default the ranks of one
node (the fast links of a node against the network between nodes), and the
line is a `SlabComm` order: line position → group rank, slice-major and
stable, so that within a slice the group's own order stays. The ranks keep
the group ranks `init_process_group` gave them; only their places on the
line move. The step is unchanged over any order.

`halo_bytes_per_boundary` is what the port's exchange really sends across
one boundary a step, per direction, at given capacities.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from tpusph_torch.dist.comm import _packed_size


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A slice-major line of ranks: `order[i]` is the group rank at line
    position i and `slice_of[i]` its slice (non-decreasing along the
    line)."""

    order: tuple[int, ...]
    slice_of: tuple[int, ...]

    @property
    def n_slices(self) -> int:
        return len(set(self.slice_of))

    def dcn_boundary_pairs(self) -> list[tuple[int, int]]:
        """Line-position pairs (i, i + 1) whose exchange crosses a slice
        boundary. Slice-major order makes them exactly n_slices − 1 of the
        size − 1 links."""
        return [
            (i, i + 1)
            for i in range(len(self.slice_of) - 1)
            if self.slice_of[i] != self.slice_of[i + 1]
        ]


def rank_slices(size: int, slices=None) -> list[int]:
    """The slice of each group rank: the explicit list `slices` where
    given, else the node of each rank under torchrun (rank //
    LOCAL_WORLD_SIZE, its ranks being numbered node by node), else 0 for
    every rank (one slice)."""
    if slices is not None:
        slices = [int(s) for s in slices]
        if len(slices) != size:
            raise ValueError(f"{len(slices)} slices given for {size} ranks")
        return slices
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    if local > 0:
        return [r // local for r in range(size)]
    return [0] * size


def make_multislice_mesh(size: int, slices=None, n_slices: int | None = None) -> SliceTopology:
    """The slice-major line of `size` group ranks, stable-sorted by the
    slice of each rank (`rank_slices`). n_slices: synthetic slicing where
    every rank reports the same slice (one node, CPU validation): the ranks
    are grouped into n_slices contiguous equal blocks, and an uneven split
    raises. Ignored where the ranks already report distinct slices, as
    tpusph ignores it where devices report distinct `slice_index`."""
    slice_ids = rank_slices(size, slices)
    if len(set(slice_ids)) == 1 and n_slices is not None:
        if size % n_slices:
            raise ValueError(f"{size} devices do not split into {n_slices} slices")
        per = size // n_slices
        slice_ids = [i // per for i in range(size)]
    order = sorted(range(size), key=lambda i: slice_ids[i])  # stable
    return SliceTopology(order=tuple(order), slice_of=tuple(slice_ids[i] for i in order))


def halo_bytes_per_boundary(halo_capacity: int, migration_capacity: int) -> int:
    """Bytes a step of the z-slab engine sends across one boundary in one
    direction at these capacities: the packed messages of the two
    exchanges (`comm._packed_size`, segments aligned to 8 bytes). The halo
    message is positions and velocities (f32[6, halo_capacity]) and the
    valid mask (one byte a row); the migration message the same rows of
    migration_capacity plus the pid tags (int32). At capacities that are
    multiples of 8, as `DistConfig` requires, that is tpusph's 25 and 29
    bytes a row. Buffers have fixed capacity, so this is the bound the
    links must carry whatever the occupancy."""
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    halo = _packed_size([meta(6, halo_capacity), meta(halo_capacity, dtype=torch.bool)])
    migration = _packed_size([
        meta(6, migration_capacity), meta(migration_capacity, dtype=torch.int32),
        meta(migration_capacity, dtype=torch.bool),
    ])
    return halo + migration
