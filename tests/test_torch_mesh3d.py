"""The brick engine of the port (`tpusph_torch/dist/mesh3d.py`): one rank
without a process group, eight gloo ranks as (2, 2, 2), (1, 2, 4) and
(8, 1, 1) grids against the port's `step_cell_list` (tests/test_mesh3d.py's
cases), four ranks as a (1, 2, 2) grid against the JAX package's brick
step block by block, and the host-side helpers against the JAX package's.
Everything runs on the CPU, where the kernel wrappers take their plain
versions.

The ranks are fresh processes (`spawn_ranks`), joined under a deadline and
killed after it. What they run is in `tests/torch_mesh3d_ranks.py`.
"""

import inspect
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)
import torch_mesh3d_ranks as bricks  # noqa: E402

from tpusph_torch.core.state import dist_state_from_numpy  # noqa: E402
from tpusph_torch.dist import mesh3d  # noqa: E402
from tpusph_torch.dist.comm import BrickComm, spawn_ranks  # noqa: E402
from tpusph_torch.dist.mesh3d import Mesh3DConfig  # noqa: E402
from tpusph_torch.dist.sharded import collect_state  # noqa: E402

DEADLINE_S = 150.0


def _jax_state(seed=13):
    """tpusph's 512-particle random state (tests/test_mesh3d.py's fixture)
    as numpy arrays."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit

    st = jinit(jdefault(512, chunk_size=512), random_init=True, seed=seed)
    return {f: np.asarray(getattr(st, f)) for f in ("position", "velocity", "valid")}


def _grid(cfg):
    return ranks._as_numpy(ranks.init_state(cfg, device="cpu"))


@pytest.fixture(scope="module")
def cases():
    cfg = ranks.sparse_cfg()
    rand = _jax_state()
    diag, blob = bricks.diagonal(rand), bricks.blob()
    return {
        "rand": rand,
        "rand10": ranks.single_process(cfg, rand, 10),
        "diag": diag,
        "diag15": ranks.single_process(cfg, diag, 15),
        "click1": ranks.single_process(cfg, rand, 1, click_at=0, click=bricks.JCLICK),
        "blob": blob,
        "blob10": ranks.single_process(cfg, blob, 10),
    }


@pytest.mark.parametrize("name", ["rand", "grid"])
def test_one_brick_matches_the_single_process(name):
    """A (1, 1, 1) grid without a process group runs the whole machinery,
    every exchange returning zeros: 10 steps against the port's own
    `step_cell_list` at the reference's bars."""
    cfg = ranks.sparse_cfg() if name == "rand" else ranks.dense_cfg()
    arrays = _grid(cfg) if name == "grid" else _jax_state()
    want = ranks.single_process(cfg, arrays, 10)
    comm = BrickComm("cpu")
    assert comm.coords == (0, 0, 0) and all(comm.axis(a).size == 1 for a in range(3))
    # the whole grid sheet lies in the x band below 2h: a face with no rank
    # behind it still counts its band, as the JAX package does
    halo = cfg.padded_num_particles if name == "grid" else 256
    mcfg = Mesh3DConfig((1, 1, 1), cfg.padded_num_particles, (halo,) * 3, (128,) * 3)
    state = mesh3d.distribute_state_3d(ranks._as_state(arrays), cfg, mcfg, comm)
    step = mesh3d.make_mesh3d_step(cfg, mcfg, comm)
    for _ in range(10):
        state, aux = step(state)
    ranks._clean(aux, cfg.num_particles)
    assert int(aux.oob_count) == 0 and int(aux.max_dev_particles) == cfg.num_particles
    ranks._close(collect_state(state, cfg.num_particles, comm), want)
    np.testing.assert_array_equal(np.sort(state.pid[state.valid].numpy()),
                                  np.arange(cfg.num_particles))


def test_brick_grids_match_the_single_process(cases, tmp_path):
    """Eight gloo ranks, one spawn with every check of the count inside it
    (`torch_mesh3d_ranks.brick_checks`): the coordinate map and the lines
    of a (2, 2, 2) grid; (2, 2, 2), (1, 2, 4) and (8, 1, 1) over 10 steps
    (positions 1e-4, velocities 1e-3); a dense blob across every face;
    diagonal ±2.5 migration over 15 steps with equal and balanced planes;
    the click; halo overflow counted on the grid sheet."""
    spawn_ranks(bricks.brick_checks, 8, f"file://{tmp_path}/store", "cpu", (cases,),
                DEADLINE_S, shape=(2, 2, 2))


def test_four_bricks_match_the_jax_brick_step(tmp_path, eight_devices):
    """Four gloo ranks as a (1, 2, 2) grid against
    `tpusph.dist.mesh3d.make_mesh3d_step` on four virtual devices, from the
    same distributed state (a dense blob across the y and x faces, drifting
    ±3 along y and x, so rows migrate along both): after each of 3 steps,
    per rank the live rows as (pid, position, velocity) at rtol 1e-5 /
    atol 1e-6 and all nine DistAux fields equal. The JAX package runs its
    tile passes, the port its kernels' plain versions."""
    import jax

    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit
    from tpusph.dist import mesh3d as jmesh3d

    cfg = jdefault(512, chunk_size=512)
    shape = (1, 2, 2)
    caps = dict(mesh_shape=shape, dev_capacity=512, halo_capacity=(256,) * 3,
                migration_capacity=(128,) * 3)
    mcfg = jmesh3d.Mesh3DConfig(**caps)
    arrays = bricks.planar_drift(bricks.blob())
    st = jinit(cfg)._replace(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    mesh = jmesh3d.make_mesh(eight_devices[:4], shape)
    dstate = jmesh3d.distribute_state_3d(st, cfg, mcfg, mesh)
    as_numpy = lambda d: {k: np.asarray(jax.device_get(v)) for k, v in d._asdict().items()}
    payload = {"mcfg": caps, "start": as_numpy(dstate), "states": [], "auxs": []}
    step = jmesh3d.make_mesh3d_step(cfg, mcfg, mesh)
    for _ in range(3):
        dstate, aux = step(dstate)
        payload["states"].append(as_numpy(dstate))
        payload["auxs"].append([int(a) for a in aux])
    assert payload["auxs"][-1][2] == 0  # no window overflow on either side
    spawn_ranks(bricks.jax_brick_checks, 4, f"file://{tmp_path}/store", "cpu", (payload,),
                DEADLINE_S, shape=shape)


def test_host_helpers_mirror_the_reference():
    """`brick_owner` and `balanced_brick_planes` against the JAX package's
    on positions that include the faces, with and without planes; a brick
    that does not fit raises; a block comes out of a whole distributed
    state by `dist_state_from_numpy`, which reads only dev_capacity."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.dist import mesh3d as jmesh3d

    cfg, jcfg = ranks.sparse_cfg(), jdefault(512, chunk_size=512)
    pos = np.random.default_rng(7).uniform(0.1, 9.9, (4096, 3)).astype(np.float32)
    pos[:100] = np.arange(100, dtype=np.float32)[:, None] * np.float32(0.1)  # cell planes
    pos[100:108] = np.float32(5.0)
    pos[108:116] = np.float32(2.5)
    for shape in ((2, 2, 2), (1, 2, 4), (8, 1, 1), (3, 2, 1), (1, 1, 1)):
        planes = mesh3d.balanced_brick_planes(pos, cfg, shape)
        assert planes == jmesh3d.balanced_brick_planes(pos, jcfg, shape)
        for pl in (None, planes):
            caps = dict(mesh_shape=shape, dev_capacity=8, halo_capacity=(8,) * 3,
                        migration_capacity=(8,) * 3, axis_planes=pl)
            got = mesh3d.brick_owner(pos, cfg, Mesh3DConfig(**caps))
            want = jmesh3d.brick_owner(pos, jcfg, jmesh3d.Mesh3DConfig(**caps))
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="dev_capacity 8"):
        whole = ranks._as_state({"position": pos, "velocity": pos, "valid": np.ones(4096, bool)})
        mesh3d.distribute_state_3d(whole, cfg, Mesh3DConfig((1, 1, 1), 8, (8,) * 3, (8,) * 3),
                                   BrickComm("cpu"))
    with pytest.raises(ValueError, match="multiples of 8"):
        Mesh3DConfig((1, 1, 1), 8, (8, 12, 8), (8,) * 3).validate()
    with pytest.raises(ValueError, match="2h"):
        mesh3d._check_brick_widths(cfg, Mesh3DConfig((1, 64, 1), 8, (8,) * 3, (8,) * 3))
    with pytest.raises(ValueError, match="cell planes"):
        planes = ((0, 100), (0, 50), (0, 100))
        mesh3d._check_brick_widths(cfg, Mesh3DConfig((1, 1, 1), 8, (8,) * 3, (8,) * 3,
                                                     axis_planes=planes))
    mcfg = Mesh3DConfig((1, 2, 2), 8, (8,) * 3, (8,) * 3)
    arrays = {
        "position": np.arange(96, dtype=np.float32).reshape(32, 3),
        "velocity": -np.arange(96, dtype=np.float32).reshape(32, 3),
        "valid": np.arange(32) % 3 == 0,
        "pid": np.arange(32, dtype=np.int32),
    }
    block = dist_state_from_numpy(arrays, 2, mcfg, "cpu")
    for f in arrays:
        np.testing.assert_array_equal(getattr(block, f).numpy(), arrays[f][16:24])


def test_brick_comm_refuses_a_grid_that_is_not_the_group():
    comm = BrickComm("cpu")
    got = comm.axis(0).exchange([torch.ones(3)], [torch.ones(2)])
    assert not got[0][0].any() and not got[1][0].any()
    assert comm.reduce([3], [4])[0].tolist() == [3]
    with pytest.raises(ValueError, match="brick grid"):
        BrickComm("cpu", shape=(2, 1, 1))
    cfg = ranks.sparse_cfg()
    with pytest.raises(ValueError, match="brick grid"):
        mesh3d.make_mesh3d_step(cfg, Mesh3DConfig((1, 2, 1), 512, (8,) * 3, (8,) * 3), comm)


def test_the_brick_step_never_reads_the_device():
    """No `.item()`, `int()`, `bool()`, `.tolist()`, `.cpu()` or `.numpy()`
    in the per-rank functions: their offsets stay on the device."""
    for fn in (mesh3d._device_build3d, mesh3d._device_update3d, mesh3d._device_step3d,
               mesh3d._halo_buffers, mesh3d._append_hop, mesh3d._axis_bands,
               mesh3d._axis_migration, mesh3d._cellspace):
        src = inspect.getsource(fn)
        src = src[src.index('"""', src.index('"""') + 3):]  # past the docstring
        assert not re.search(r"\.item\(|\bint\(|\bbool\(|\.tolist\(|\.cpu\(|\.numpy\(", src), fn


def test_brick_entry_points_default_to_the_card_and_the_kernels():
    """A `BrickComm` lives on the card unless told otherwise, the step's
    backend is `kernels`, and with no nvcc to build the kernels the step is
    refused, not run another way."""
    comm = BrickComm()
    assert comm.device.type == "cuda"
    makers = (mesh3d.make_mesh3d_step, mesh3d.make_mesh3d_timed, mesh3d.make_mesh3d_run)
    for make in makers:
        assert inspect.signature(make).parameters["backend"].default == "kernels"
    cfg = ranks.sparse_cfg()
    mcfg = Mesh3DConfig((1, 1, 1), 512, (256,) * 3, (128,) * 3)
    if not torch.cuda.is_available():
        for make in (mesh3d.make_mesh3d_step, mesh3d.make_mesh3d_timed):
            with pytest.raises(RuntimeError, match="nvcc"):
                make(cfg, mcfg, comm)
    for name in ("auto", "pallas", "kernels", "cell_list"):
        mesh3d.make_mesh3d_step(cfg, mcfg, BrickComm("cpu"), name)
    with pytest.raises(ValueError, match="kernels"):
        mesh3d.make_mesh3d_step(cfg, mcfg, BrickComm("cpu"), "allpairs")


def test_timed_stages_and_run_are_the_step():
    """On a (1, 1, 1) grid: build then update is one step without a
    click, and `make_mesh3d_run(5)` is five steps, bit for bit, with the
    counters folded over the chain."""
    cfg = ranks.dense_cfg()
    comm = BrickComm("cpu")
    mcfg = Mesh3DConfig((1, 1, 1), cfg.padded_num_particles, (1024,) * 3, (128,) * 3)
    start = mesh3d.distribute_state_3d(ranks._as_state(_grid(cfg)), cfg, mcfg, comm)
    step = mesh3d.make_mesh3d_step(cfg, mcfg, comm)
    build, update = mesh3d.make_mesh3d_timed(cfg, mcfg, comm)
    one, aux1 = step(start)
    timed, aux_t = update(*build(start))
    ranks._same(timed, one)
    assert [int(a) for a in aux_t] == [int(a) for a in aux1]
    five = start
    for _ in range(5):
        five, aux5 = step(five)
    ran, aux_run = mesh3d.make_mesh3d_run(cfg, mcfg, comm, 5)(start)
    ranks._same(ran, five)
    ranks._clean(aux_run, cfg.num_particles)
    assert int(aux_run.max_halo_send) == int(aux5.max_halo_send) > 0
