"""The sharded engines' graphed entry points on ranks with peers: each of
tpusph's jitted multi-device dispatches as a chain of CUDA-graph segments
split at the exchanges and the reduce (`tpusph_torch/engine/graphs.py::
SegmentedLoop`, `tpusph_torch/dist/sharded.py::RankGraphs`).

On the CPU a segmented body runs under the capture guard with its
transports let through, and its boundaries are counted as a card captures
them. Here: the loop on its own; 2 and 4 slab ranks and (2, 1, 1) and
(1, 2, 2) brick grids, every graphed entry point against its `.eager` bit
for bit with the chain of each body; two slab ranks and a (1, 2, 2) grid
against tpusph's jitted step and run; a host read planted on one rank
fails the spawn within its deadline; `DistSimulator` on two ranks makes
one capture a growth. gloo ranks on the CPU (`spawn_ranks`), small N, one
thread a rank; what they run is in `tests/torch_dist_ranks.py` and
`tests/torch_mesh3d_ranks.py`.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)
import torch_mesh3d_ranks as bricks  # noqa: E402

from tpusph_torch.dist.comm import spawn_ranks  # noqa: E402
from tpusph_torch.engine import graphs  # noqa: E402
from tpusph_torch.engine.graphs import HostReadError, SegmentedLoop  # noqa: E402

DEADLINE_S = 150.0


@pytest.fixture(scope="module")
def cases():
    return {"grid": ranks._as_numpy(ranks.init_state(ranks.dense_cfg(), device="cpu")),
            "blob": bricks.blob()}


# ------------------------------------------------------- the loop on its own


def _transport(t):
    t.cpu()  # a host read: the guard lets a transport through
    return [t + 1]


# body of one tensor -> outputs, and the chain the loop finds in it
BODIES = {
    "split": (lambda x: [graphs.cross("exchange", _transport, [x * 2], [x])[0] * 3],
              ["segment", "exchange", "segment"]),
    "ends_at_a_transport": (lambda x: graphs.cross("reduce", _transport, [x * 2], [x]),
                            ["segment", "reduce"]),
    "starts_at_a_transport": (lambda x: [graphs.cross("gather", _transport, [x], [x])[0] * 3],
                              ["gather", "segment"]),
    "two_transports": (
        lambda x: [graphs.cross("reduce", _transport,
                                [graphs.cross("exchange", _transport, [x - 1], [x])[0] * 2],
                                [x])[0]],
        ["segment", "exchange", "segment", "reduce"]),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_a_segmented_body_splits_at_each_transport(name):
    """A segment begins at the body's first tensor operation after a
    boundary: a body that ends or starts at a transport has no empty
    segment there. On the CPU the transports run, past the guard, and the
    outputs are the body's run eagerly; the chain is the first call's and
    each loop counts one capture."""
    body, chain = BODIES[name]
    x = torch.arange(4.0)
    loop = SegmentedLoop(lambda inputs: body(inputs[0]), "cpu")
    before = graphs.captures
    for _ in range(2):
        got = loop([x])
        assert loop.structure == chain
        assert all(torch.equal(a, b) for a, b in zip(got, body(x)))
    assert graphs.captures - before == 1


def test_a_segmented_body_reads_nothing():
    """A host read in a segmented body, outside a transport, raises."""
    def body(inputs):
        (y,) = graphs.cross("exchange", _transport, [inputs[0]], [inputs[0]])
        y.sum().item()
        return [y]

    with pytest.raises(HostReadError):
        SegmentedLoop(body, "cpu")([torch.ones(3)])


# ------------------------------------------------------------- slab ranks


@pytest.mark.parametrize("size", [2, 4])
def test_slab_graphs_replay_the_eager_entry_points(cases, size, tmp_path):
    """`size` slab ranks over gloo (`torch_dist_ranks.slab_graph_checks`):
    the graphed step without and with a click, the timed stages and
    `run(3)` each equal their `.eager` bit for bit after each of 3 calls,
    the nine DistAux fields and their dtypes included; a step is three
    segments, two exchanges and one reduce on every rank, the ends of the
    line included."""
    spawn_ranks(ranks.slab_graph_checks, size, f"file://{tmp_path}/store", "cpu", (cases,),
                DEADLINE_S)


def test_two_slab_ranks_graphed_match_tpusph(tmp_path, eight_devices):
    """Two gloo ranks' graphed step and run against tpusph's jitted
    `make_sharded_step` and `make_sharded_run` on two virtual devices, from
    the same DistState (512 particles of the grid init with the ±3 z
    drift, so some migrate): per rank the live rows by pid at rtol 1e-5 /
    atol 1e-6 and the nine DistAux fields equal, after each of 3 steps and
    after the 3-step run."""
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
    start = jsharded.distribute_state(st._replace(velocity=drift), cfg, jdcfg, mesh)
    as_numpy = lambda d: {k: np.asarray(jax.device_get(v)) for k, v in d._asdict().items()}
    payload = {"dcfg": caps, "start": as_numpy(start), "states": [], "auxs": []}
    step, dstate = jsharded.make_sharded_step(cfg, jdcfg, mesh), start
    for _ in range(3):
        dstate, aux = step(dstate)
        payload["states"].append(as_numpy(dstate))
        payload["auxs"].append([int(a) for a in aux])
    dstate, aux = jsharded.make_sharded_run(cfg, jdcfg, mesh, 3)(start)
    payload["run"], payload["run_aux"] = as_numpy(dstate), [int(a) for a in aux]
    spawn_ranks(ranks.jax_graph_checks, 2, f"file://{tmp_path}/store", "cpu", (payload,),
                DEADLINE_S)


def test_a_host_read_in_a_segmented_body_fails_the_spawn(tmp_path):
    """A `.item()` planted in rank 0's graphed step raises `HostReadError`
    there while rank 1 waits in the migration exchange: the spawn fails
    with rank 0's error well within its deadline."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="HostReadError"):
        spawn_ranks(ranks.planted_read, 2, f"file://{tmp_path}/store", "cpu", (), 60.0)
    assert time.monotonic() - t0 < 60.0


def test_two_rank_simulator_captures_once_a_growth(tmp_path):
    """`DistSimulator` on two ranks from halo and migration capacities of 8
    rows: every growth makes the step again, captured once more on both
    ranks, and 4 steps end within 1e-6 of an ample run."""
    spawn_ranks(ranks.simulator_growth, 2, f"file://{tmp_path}/store", "cpu", (), DEADLINE_S)


# ------------------------------------------------------------ brick grids


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 2)], ids=["2x1x1", "1x2x2"])
def test_brick_graphs_replay_the_eager_entry_points(cases, shape, tmp_path):
    """A brick grid over gloo (`torch_mesh3d_ranks.brick_graph_checks`):
    every graphed entry point against its `.eager` bit for bit, and one
    exchange a halo phase and a migration hop along each axis with a peer
    (a (1, 2, 2) step: four exchanges and one reduce)."""
    spawn_ranks(bricks.brick_graph_checks, int(np.prod(shape)), f"file://{tmp_path}/store",
                "cpu", (cases,), DEADLINE_S, shape=shape)


def test_four_bricks_graphed_match_tpusph(tmp_path, eight_devices):
    """Four gloo ranks as a (1, 2, 2) grid: the graphed step and `run(3)`
    against tpusph's jitted `make_mesh3d_step` and `make_mesh3d_run` on
    four virtual devices from the same distributed state (the blob
    drifting ±3 along y and x): per rank the live rows by pid at rtol 1e-5
    / atol 1e-6 and the nine DistAux fields equal, after each of 3 steps
    and after the run."""
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
    start = jmesh3d.distribute_state_3d(st, cfg, mcfg, mesh)
    as_numpy = lambda d: {k: np.asarray(jax.device_get(v)) for k, v in d._asdict().items()}
    payload = {"mcfg": caps, "start": as_numpy(start), "states": [], "auxs": []}
    step, dstate = jmesh3d.make_mesh3d_step(cfg, mcfg, mesh), start
    for _ in range(3):
        dstate, aux = step(dstate)
        payload["states"].append(as_numpy(dstate))
        payload["auxs"].append([int(a) for a in aux])
    dstate, aux = jmesh3d.make_mesh3d_run(cfg, mcfg, mesh, 3)(start)
    payload["run"], payload["run_aux"] = as_numpy(dstate), [int(a) for a in aux]
    spawn_ranks(bricks.jax_graph_brick_checks, 4, f"file://{tmp_path}/store", "cpu", (payload,),
                DEADLINE_S, shape=shape)
