"""The z-slab sharded engine of the port (`tpusph_torch/dist/`): the
per-rank functions on a line of one rank without any process group, real
ranks over gloo against the single process, and two ranks against the JAX
package's `shard_map` step, block by block. Everything runs on the CPU,
where the kernel wrappers take their plain versions.

The ranks are fresh processes (`spawn_ranks`), joined under a deadline and
killed after it; their group gives up after 60 s. What they run is in
`tests/torch_dist_ranks.py`.
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

from tpusph_torch.core.state import dist_state_from_numpy  # noqa: E402
from tpusph_torch.dist import sharded  # noqa: E402
from tpusph_torch.dist.comm import SlabComm, _pack, _unpack, spawn_ranks  # noqa: E402
from tpusph_torch.dist.sharded import (  # noqa: E402
    DistConfig,
    collect_state,
    distribute_state,
    make_sharded_step,
)

DEADLINE_S = 150.0


@pytest.fixture(scope="module")
def cases():
    return ranks.make_cases()


@pytest.mark.parametrize("full", [False, True], ids=["elided", "full_machinery"])
@pytest.mark.parametrize("backend", ["cell_list", "kernels"])
@pytest.mark.parametrize("name", ["rand", "grid"])
def test_one_rank_matches_the_single_process(cases, name, backend, full, monkeypatch):
    """D = 1 without a process group, elided and through the whole
    multi-rank machinery with dead halos, 10 steps against the port's own
    `step_cell_list` at the reference's bars."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1" if full else "0")
    cfg = ranks.sparse_cfg() if name == "rand" else ranks.dense_cfg()
    comm = SlabComm("cpu")
    dcfg = DistConfig(1, cfg.padded_num_particles, 256, 128)
    assert sharded._elide_single(dcfg) != full
    state = distribute_state(ranks._as_state(cases[name]), cfg, dcfg, comm)
    step = make_sharded_step(cfg, dcfg, comm, backend)
    for _ in range(10):
        state, aux = step(state)
    ranks._clean(aux, cfg.num_particles)
    assert int(aux.oob_count) == 0 and int(aux.max_dev_particles) == cfg.num_particles
    ranks._close(collect_state(state, cfg.num_particles, comm), cases[name + "10"])
    pid = np.sort(state.pid[state.valid].numpy())
    np.testing.assert_array_equal(pid, np.arange(cfg.num_particles))


@pytest.mark.parametrize("size", [2, 4, 8])
def test_ranks_match_the_single_process(cases, size, tmp_path):
    """Real ranks over gloo, one spawn a rank count with all of that
    count's checks inside it (`torch_dist_ranks.rank_checks`): D = 2 is the
    splice path, D = 8 the merge sort (100 % 8 != 0), D = 4 also runs
    balanced planes."""
    spawn_ranks(
        ranks.rank_checks, size, f"file://{tmp_path}/store", "cpu", (cases,), DEADLINE_S
    )


def test_a_failing_rank_fails_the_spawn(tmp_path):
    with pytest.raises(Exception, match="boom on rank 1"):
        spawn_ranks(_boom, 2, f"file://{tmp_path}/store", "cpu", (), 60.0)


def _boom(comm):
    if comm.rank == 1:
        raise RuntimeError("boom on rank 1")
    comm.shift([torch.zeros(4)])  # rank 0 waits for a peer that is gone


def test_two_ranks_match_the_jax_sharded_step(tmp_path, eight_devices):
    """Two gloo ranks against `tpusph.dist.sharded.make_sharded_step` on
    two virtual devices, started from the same DistState (512 particles of
    the grid init, which interact across the face, with the ±3 z drift,
    so some migrate): after each of 3 steps, per rank the live rows as
    (pid, position, velocity) at rtol 1e-5 / atol 1e-6 and all nine
    DistAux fields equal. Both sides run their tile passes."""
    import jax
    from jax.sharding import Mesh

    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit
    from tpusph.dist import sharded as jsharded

    cfg = jdefault(512, chunk_size=512)
    mesh = Mesh(np.array(eight_devices[:2]), ("z",))
    caps = dict(n_devices=2, dev_capacity=512, halo_capacity=256, migration_capacity=128)
    jdcfg = jsharded.DistConfig(**caps)
    st = jinit(cfg)
    drift = ranks.drifting({"velocity": np.asarray(st.velocity)})["velocity"]
    dstate = jsharded.distribute_state(st._replace(velocity=drift), cfg, jdcfg, mesh)
    as_numpy = lambda d: {k: np.asarray(jax.device_get(v)) for k, v in d._asdict().items()}
    payload = {"dcfg": caps, "start": as_numpy(dstate), "states": [], "auxs": []}
    step = jsharded.make_sharded_step(cfg, jdcfg, mesh)
    for _ in range(3):
        dstate, aux = step(dstate)
        payload["states"].append(as_numpy(dstate))
        payload["auxs"].append([int(a) for a in aux])
    spawn_ranks(ranks.jax_checks, 2, f"file://{tmp_path}/store", "cpu", (payload,), DEADLINE_S)


def test_dist_state_from_numpy_takes_a_rank_s_block():
    dcfg = DistConfig(2, 8, 8, 8)
    arrays = {
        "position": np.arange(48, dtype=np.float32).reshape(16, 3),
        "velocity": -np.arange(48, dtype=np.float32).reshape(16, 3),
        "valid": np.arange(16) % 3 == 0,
        "pid": np.arange(16, dtype=np.int32),
    }
    block = dist_state_from_numpy(arrays, 1, dcfg, "cpu")
    for f in arrays:
        np.testing.assert_array_equal(getattr(block, f).numpy(), arrays[f][8:])
    assert block.pid.dtype == torch.int32 and block.valid.dtype == torch.bool


def test_pack_round_trip_and_single_rank_exchange():
    tensors = [
        torch.arange(18, dtype=torch.float32).reshape(6, 3),
        torch.arange(5, dtype=torch.int32) - 2,
        torch.tensor([True, False, True]),
    ]
    for got, want in zip(_unpack(_pack(tensors), tensors), tensors):
        assert got.dtype == want.dtype and torch.equal(got, want)
    comm = SlabComm("cpu")
    below, above = comm.exchange(tensors, tensors[:1])
    assert [t.shape for t in below] == [t.shape for t in tensors] and len(above) == 1
    assert not any(t.any() for t in below + above)
    assert not comm.shift(tensors, up=False)[2].any()
    sums, maxes = comm.reduce([3, torch.tensor(4)], [5])
    assert sums.tolist() == [3, 4] and maxes.tolist() == [5] and sums.dtype == torch.int32


def test_host_side_partition_mirrors_the_reference():
    """`slab_owner` and `balanced_slab_planes` against the JAX package's on
    the same z, with and without planes; a slab that does not fit raises."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.dist import sharded as jsharded

    cfg, jcfg = ranks.sparse_cfg(), jdefault(512, chunk_size=512)
    z = np.random.default_rng(5).uniform(0.1, 9.9, 4096).astype(np.float32)
    z[:64] = np.arange(64, dtype=np.float32) * np.float32(0.1)  # on the faces
    for d in (2, 3, 4, 8):
        planes = sharded.balanced_slab_planes(z, cfg, d)
        assert planes == jsharded.balanced_slab_planes(z, jcfg, d)
        for pl in (None, planes):
            got = sharded.slab_owner(z, cfg, DistConfig(d, 8, 8, 8, slab_planes=pl))
            want = jsharded.slab_owner(z, jcfg, jsharded.DistConfig(d, 8, 8, 8, slab_planes=pl))
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of 8"):
        DistConfig(2, 12, 8, 8).validate()
    with pytest.raises(ValueError, match="2h"):
        sharded._check_slab_width(cfg, DistConfig(64, 8, 8, 8))
    with pytest.raises(ValueError, match="cell planes"):
        sharded._check_slab_width(cfg, DistConfig(2, 8, 8, 8, slab_planes=(0, 50)))


def test_a_slab_that_does_not_fit_raises(cases):
    cfg = ranks.sparse_cfg()
    with pytest.raises(ValueError, match="dev_capacity 8"):
        distribute_state(ranks._as_state(cases["rand"]), cfg, DistConfig(1, 8, 8, 8), SlabComm("cpu"))
    with pytest.raises(ValueError, match="2 slabs"):
        make_sharded_step(cfg, DistConfig(2, 512, 256, 128), SlabComm("cpu"))


def test_the_step_never_reads_the_device():
    """No `.item()`, `int()`, `bool()`, `float()`, `.tolist()` or `.cpu()`
    in the per-rank functions: their offsets stay on the device. The one
    read a step is the migration-free sort skip's decision, a single
    `.tolist()` in `_skip_order` (module docstring §6)."""
    reads = r"\.item\(|\bint\(|\bbool\(|\.tolist\(|\.cpu\(|\.numpy\("
    for fn in (sharded._device_build, sharded._device_update, sharded._device_step,
               sharded._compute_sorted_fields, sharded._take, sharded._put, sharded._compact,
               sharded._final_hop, sharded._skip_order):
        src = inspect.getsource(fn)
        src = src[src.index('"""', src.index('"""') + 3):]  # past the docstring
        found = re.findall(reads, src)
        assert found == ([".tolist("] if fn is sharded._skip_order else []), (fn, found)


def test_entry_points_default_to_the_card_and_the_kernels():
    """A `SlabComm` lives on the card unless told otherwise, the step's
    backend is `kernels` (tpusph's names for it included), and with no
    nvcc to build the kernels the step is refused, not run another way."""
    comm = SlabComm()
    assert comm.device.type == "cuda" and comm.size == 1 and comm.rank == 0
    for make in (sharded.make_sharded_step, sharded.make_sharded_timed, sharded.make_sharded_run):
        assert inspect.signature(make).parameters["backend"].default == "kernels"
    cfg = ranks.sparse_cfg()
    dcfg = DistConfig(1, 512, 256, 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nvcc"):
            make_sharded_step(cfg, dcfg, comm)
    for name in ("auto", "pallas", "kernels", "cell_list"):
        make_sharded_step(cfg, dcfg, SlabComm("cpu"), name)
    with pytest.raises(ValueError, match="kernels"):
        make_sharded_step(cfg, dcfg, SlabComm("cpu"), "allpairs")
    whole = ranks._as_state(ranks._as_numpy(ranks.init_state(cfg, True, 13, "cpu")))
    state = distribute_state(whole, cfg, dcfg, SlabComm("cpu"))
    with pytest.raises(ValueError, match="state is on"):
        sharded._check_device(state, comm)
