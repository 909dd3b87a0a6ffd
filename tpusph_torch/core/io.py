"""Checkpoints: state and config in one `.npz`, the format of
`tpusph/core/io.py`. A checkpoint written by either package loads in the
other (the JAX package's `pallas_*` config keys, and its DistConfig's
`axis_name`, are dropped here).

A sharded run's checkpoint (`save_dist_state`) holds the whole state
ordered by pid, so `load_dist_state` can restore it onto any number of
ranks."""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np

from tpusph_torch.core.config import SimConfig, config_from_dict
from tpusph_torch.core.state import FluidState, state_from_numpy, state_to_numpy


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(dataclasses.asdict(obj)).encode(), dtype=np.uint8)


def save_state(path: str, state: FluidState, cfg: SimConfig) -> None:
    arrays = state_to_numpy(state)
    arrays["__config__"] = _json_bytes(cfg)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device="cuda") -> tuple[FluidState, SimConfig]:
    with np.load(path) as data:
        cfg = config_from_dict(json.loads(bytes(data["__config__"]).decode()))
        state = state_from_numpy(data, device)
    return state, cfg


def save_dist_state(path: str, dist_state, cfg: SimConfig, dcfg, comm) -> None:
    """Checkpoint a sharded run: every rank of `comm` calls it with its
    block. The blocks are gathered and ordered by pid
    (`sharded.collect_state`), and rank 0 writes the whole state with the
    SimConfig and the DistConfig it ran under. A pid on no rank raises a
    ValueError on every rank."""
    from tpusph_torch.dist.sharded import collect_state

    host = collect_state(dist_state, cfg.num_particles, comm)
    if np.isnan(host["position"]).any():
        raise ValueError(
            "dist checkpoint incomplete: some particle ids missing "
            "(conservation broken before save)"
        )
    if comm.rank == 0:
        np.savez_compressed(
            path, position=host["position"], velocity=host["velocity"],
            __config__=_json_bytes(cfg), __dist_config__=_json_bytes(dcfg),
        )


def load_dist_state(path: str, comm=None, dcfg=None, device="cuda"):
    """Restore a checkpoint of `save_dist_state` (or of tpusph's) onto the
    ranks of `comm` (None: one rank with no group on `device`), which may
    be more or fewer than it was saved from: every rank takes its slab's
    block of the whole state. dcfg=None keeps the saved DistConfig on the
    same rank count and takes `default_dist_config` on another. Returns
    (DistState, SimConfig, DistConfig)."""
    from tpusph_torch.dist.comm import SlabComm
    from tpusph_torch.dist.sharded import DistConfig, distribute_state

    if comm is None:
        comm = SlabComm(device)
    with np.load(path) as data:
        cfg = config_from_dict(json.loads(bytes(data["__config__"]).decode()))
        saved = json.loads(bytes(data["__dist_config__"]).decode())
        pos = np.asarray(data["position"], np.float32)
        vel = np.asarray(data["velocity"], np.float32)
    saved.pop("axis_name", None)  # tpusph's mesh axis; a line of ranks has none
    if saved.get("slab_planes") is not None:
        saved["slab_planes"] = tuple(saved["slab_planes"])  # JSON gives a list
    if dcfg is None:
        if comm.size == saved["n_devices"]:
            dcfg = DistConfig(**saved)
        else:
            from tpusph_torch.dist.simulator import default_dist_config

            dcfg = default_dist_config(cfg, comm.size)
    whole = types.SimpleNamespace(position=pos, velocity=vel, valid=np.ones(len(pos), bool))
    return distribute_state(whole, cfg, dcfg, comm), cfg, dcfg
