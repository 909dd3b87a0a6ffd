"""Checkpoints: state and config in one `.npz`, the format of
`tpusph/core/io.py`. A checkpoint written by either package loads in the
other (the JAX package's `pallas_*` config keys are dropped here)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from tpusph_torch.core.config import SimConfig, config_from_dict
from tpusph_torch.core.state import FluidState, state_from_numpy, state_to_numpy


def save_state(path: str, state: FluidState, cfg: SimConfig) -> None:
    arrays = state_to_numpy(state)
    arrays["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_state(path: str, device="cpu") -> tuple[FluidState, SimConfig]:
    with np.load(path) as data:
        cfg = config_from_dict(json.loads(bytes(data["__config__"]).decode()))
        state = state_from_numpy(data, device)
    return state, cfg
