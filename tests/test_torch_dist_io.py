"""Sharded checkpoints (`tpusph_torch/core/io.py::save_dist_state`,
`load_dist_state`), the counterparts of tpusph's: a run saved on one rank
count resumes on another as the uninterrupted run continues, and a
checkpoint written by either package loads in the other. Everything runs
on the CPU; the rank functions are in `tests/torch_dist_ranks.py`.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)

from tpusph_torch.core import io as tio  # noqa: E402
from tpusph_torch.dist.comm import SlabComm, spawn_ranks  # noqa: E402
from tpusph_torch.dist.sharded import DistConfig, collect_state, distribute_state  # noqa: E402
from tpusph_torch.dist.simulator import default_dist_config  # noqa: E402

DEADLINE_S = 150.0


def test_save_on_four_ranks_resume_on_two(tmp_path):
    """tpusph's round trip (tests/test_dist_simulator.py:107-141) with
    ranks for devices: save after 2 steps on 4 ranks, load onto 2, run 2
    more; positions by pid within 1e-5 of 4 uninterrupted steps."""
    path, ref = str(tmp_path / "dist.npz"), str(tmp_path / "ref.npy")
    spawn_ranks(ranks.checkpoint_save, 4, f"file://{tmp_path}/store4", "cpu", (path, ref),
                DEADLINE_S)
    assert {"dist.npz", "ref.npy"} <= set(os.listdir(tmp_path))
    spawn_ranks(ranks.checkpoint_resume, 2, f"file://{tmp_path}/store2", "cpu", (path, ref),
                DEADLINE_S)


def _one_rank_state(cfg, dcfg):
    whole = ranks._as_state(ranks._as_numpy(ranks.init_state(cfg, True, 13, "cpu")))
    return distribute_state(whole, cfg, dcfg, SlabComm("cpu")), whole


def test_same_rank_count_keeps_the_saved_config(tmp_path):
    """On the rank count it was saved from, the checkpoint's DistConfig
    comes back (slab planes as a tuple); a DistConfig passed in wins;
    positions and velocities by pid are the saved ones, bit for bit."""
    cfg = ranks.sparse_cfg()
    dcfg = DistConfig(1, 512, 256, 128, slab_planes=(0, 100))
    state, whole = _one_rank_state(cfg, dcfg)
    path = str(tmp_path / "one.npz")
    tio.save_dist_state(path, state, cfg, dcfg, SlabComm("cpu"))
    got, cfg2, dcfg2 = tio.load_dist_state(path, device="cpu")
    assert cfg2 == cfg and dcfg2 == dcfg and isinstance(dcfg2.slab_planes, tuple)
    for a, b in zip(got, state):
        assert torch.equal(a, b)
    other = DistConfig(1, 1024, 256, 128)
    got, _, dcfg3 = tio.load_dist_state(path, SlabComm("cpu"), dcfg=other)
    assert dcfg3 == other and got.position.shape == (1024, 3)
    np.testing.assert_array_equal(collect_state(got, 512, SlabComm("cpu"))["position"],
                                  whole.position.numpy()[:512])


def test_a_missing_pid_raises(tmp_path):
    """A particle on no rank (conservation broken) refuses the save, as
    tpusph does, and writes nothing."""
    cfg = ranks.sparse_cfg()
    dcfg = DistConfig(1, 512, 256, 128)
    state, _ = _one_rank_state(cfg, dcfg)
    valid = state.valid.clone()
    valid[7] = False
    path = str(tmp_path / "lost.npz")
    with pytest.raises(ValueError, match="missing"):
        tio.save_dist_state(path, state._replace(valid=valid), cfg, dcfg, SlabComm("cpu"))
    assert not os.path.exists(path)


def _jax_mesh(devices):
    from jax.sharding import Mesh

    return Mesh(np.array(devices), ("z",))


def _same_config(port_cfg, jax_cfg):
    fields = dataclasses.asdict(port_cfg)
    assert fields == {k: getattr(jax_cfg, k) for k in fields}


@pytest.mark.parametrize("devices", [1, 2])
def test_tpusph_checkpoint_loads_in_the_port(tmp_path, eight_devices, devices):
    """tpusph's `save_dist_state` on 1 device (balanced slab planes) or 2,
    the port's `load_dist_state` on one rank: the same SimConfig, the saved
    DistConfig less its `axis_name` where the rank count is the same (the
    default one otherwise), the positions and velocities by pid equal."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit
    from tpusph.core.io import save_dist_state as jsave
    from tpusph.dist import sharded as jsharded

    jcfg = jdefault(512, chunk_size=512)
    st = jinit(jcfg, random_init=True, seed=13)
    planes = jsharded.balanced_slab_planes(np.asarray(st.position[:512, 2]), jcfg, devices)
    jdcfg = jsharded.DistConfig(devices, 512, 256, 128, slab_planes=planes)
    mesh = _jax_mesh(eight_devices[:devices])
    dstate = jsharded.distribute_state(st, jcfg, jdcfg, mesh)
    path = str(tmp_path / "jax.npz")
    jsave(path, dstate, jcfg, jdcfg)
    want = jsharded.collect_state(dstate, 512)

    state, cfg, dcfg = tio.load_dist_state(path, device="cpu")
    _same_config(cfg, jcfg)
    if devices == 1:
        assert dcfg == DistConfig(1, 512, 256, 128, slab_planes=tuple(planes))
    else:
        assert dcfg == default_dist_config(cfg, 1)
    got = collect_state(state, 512, SlabComm("cpu"))
    for f in ("position", "velocity"):
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("devices", [1, 2])
def test_port_checkpoint_loads_in_tpusph(tmp_path, eight_devices, devices):
    """The port's `save_dist_state` on one rank with slab planes,
    tpusph's `load_dist_state` on 1 device (the saved DistConfig, its
    `axis_name` the default) or 2 (its default one): the same SimConfig,
    positions and velocities by pid equal."""
    from tpusph.core.io import load_dist_state as jload
    from tpusph.dist import sharded as jsharded

    cfg = ranks.sparse_cfg()
    dcfg = DistConfig(1, 512, 256, 128, slab_planes=(0, 100))
    state, _ = _one_rank_state(cfg, dcfg)
    path = str(tmp_path / "port.npz")
    tio.save_dist_state(path, state, cfg, dcfg, SlabComm("cpu"))
    want = collect_state(state, 512, SlabComm("cpu"))

    jstate, jcfg, jdcfg = jload(path, _jax_mesh(eight_devices[:devices]))
    _same_config(cfg, jcfg)
    assert jdcfg.n_devices == devices and jdcfg.axis_name == "z"
    if devices == 1:
        assert jdcfg.slab_planes == (0, 100) and jdcfg.dev_capacity == 512
    got = jsharded.collect_state(jstate, 512)
    for f in ("position", "velocity"):
        np.testing.assert_array_equal(got[f], want[f])
