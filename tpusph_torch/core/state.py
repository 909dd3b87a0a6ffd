"""Particle state as a structure of arrays.

Counterpart of `tpusph/core/state.py`. `valid` marks live particle slots:
the state is padded to a chunk multiple, and padding slots are invalid,
parked at the origin, and carry the out-of-range sentinel key so they join
no cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FluidState:
    position: torch.Tensor  # f32[N, 3]
    velocity: torch.Tensor  # f32[N, 3]
    force: torch.Tensor  # f32[N, 3]
    density: torch.Tensor  # f32[N]
    pressure: torch.Tensor  # f32[N]
    valid: torch.Tensor  # bool[N]

    @property
    def num_slots(self) -> int:
        return self.position.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device


FIELDS = tuple(f.name for f in dataclasses.fields(FluidState))


def make_state(
    position: torch.Tensor, num_valid: int | None = None
) -> FluidState:
    """Zero-velocity state from positions (the reference Particle ctor,
    simulator.h:39-46)."""
    n = position.shape[0]
    dev = position.device
    position = position.to(torch.float32)
    if num_valid is None:
        num_valid = n
    return FluidState(
        position=position,
        velocity=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        force=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        density=torch.zeros((n,), dtype=torch.float32, device=dev),
        pressure=torch.zeros((n,), dtype=torch.float32, device=dev),
        valid=torch.arange(n, device=dev) < num_valid,
    )


def pad_state(state: FluidState, target_slots: int) -> FluidState:
    """Pad to `target_slots` with invalid particles parked at the origin."""
    n = state.num_slots
    if target_slots < n:
        raise ValueError("target_slots must be >= current slots")
    if target_slots == n:
        return state
    pad = target_slots - n

    def padded(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

    return FluidState(**{f: padded(getattr(state, f)) for f in FIELDS})


def state_from_numpy(arrays, device) -> FluidState:
    """FluidState from a mapping of numpy arrays (for example the JAX
    package's state after `np.asarray`). The arrays are copied: numpy views
    of JAX arrays are read-only."""
    return FluidState(
        **{
            f: torch.from_numpy(np.array(arrays[f], copy=True)).to(device)
            for f in FIELDS
        }
    )


def state_to_numpy(state: FluidState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


def dist_state_from_numpy(arrays, rank: int, dcfg, device):
    """Rank `rank`'s block, a `dist.sharded.DistState` on `device`, of a
    distributed state given whole: `arrays` maps position, velocity, valid
    and pid to numpy arrays of `n_devices · dev_capacity` rows, block after
    block (for example the JAX package's `DistState` after `np.asarray`).
    The arrays are copied."""
    from tpusph_torch.dist.sharded import DistState

    rows = slice(rank * dcfg.dev_capacity, (rank + 1) * dcfg.dev_capacity)
    return DistState(
        *(
            torch.from_numpy(np.array(arrays[f][rows], copy=True)).to(device)
            for f in DistState._fields
        )
    )
