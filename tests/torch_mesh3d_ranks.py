"""What the ranks of `tests/test_torch_mesh3d.py`,
`tests/test_torch_multislice.py` and `tests/test_torch_dist_simulator.py`
run. Like `torch_dist_ranks.py` it imports no JAX: `spawn_ranks` starts
fresh processes that import the module of the function they are given.

The parents build the states and the single-process results (numpy arrays,
so they pickle); each function here is one rank's share of every check of
its rank count, and a failing assert in any rank fails the spawn.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_dist_ranks import _as_state, _clean, _close, sparse_cfg

from tpusph_torch.core.config import default_config
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import dist_state_from_numpy, state_from_numpy
from tpusph_torch.dist.comm import BrickComm, SlabComm
from tpusph_torch.dist.mesh3d import (
    Mesh3DConfig,
    balanced_brick_planes,
    distribute_state_3d,
    make_mesh3d_step,
)
from tpusph_torch.dist.multislice import make_multislice_mesh
from tpusph_torch.dist.sharded import DistConfig, collect_state, distribute_state, make_sharded_step
from tpusph_torch.dist.simulator import DistSimulator

GRIDS = ((2, 2, 2), (1, 2, 4), (8, 1, 1))
JCLICK = (400, 300)  # tests/test_mesh3d.py's click, the box centre


def diagonal(arrays: dict, speed: float = 2.5) -> dict:
    """±speed along all three axes, alternating by row, so that particles
    cross brick corners (tests/test_mesh3d.py:85-91)."""
    vel = np.where((np.arange(len(arrays["velocity"])) % 2 == 0)[:, None],
                   np.float32(speed), np.float32(-speed)) * np.ones((1, 3), np.float32)
    return dict(arrays, velocity=vel.astype(np.float32))


def blob(n: int = 512) -> dict:
    """A cubic lattice of n particles, spacing 0.9h, centred on (5, 5, 5):
    it straddles every face of a (2, 2, 2) grid, and its particles
    interact across them."""
    side = round(n ** (1 / 3))
    g = np.float32(5.0) + np.float32(0.09) * (np.arange(side, dtype=np.float32) - (side - 1) / 2)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(np.float32)
    return {"position": pos, "velocity": np.zeros_like(pos), "valid": np.ones(n, bool)}


def planar_drift(arrays: dict, speed: float = 3.0) -> dict:
    """±speed along y and x, alternating by row: migration across the y
    and x faces of a (1, 2, 2) grid."""
    vel = np.zeros_like(arrays["velocity"])
    sign = np.where(np.arange(len(vel)) % 2 == 0, speed, -speed).astype(np.float32)
    vel[:, 0], vel[:, 1] = sign, sign
    return dict(arrays, velocity=vel)


def mcfg_of(shape, cap: int = 512, **kw) -> Mesh3DConfig:
    return Mesh3DConfig(shape, cap, (256,) * 3, (128,) * 3, **kw)


def _advance(step, state, steps: int, click_at=None, click=None):
    aux = None
    for k in range(steps):
        state, aux = step(state, click_px=click if k == click_at else None)
    return state, aux


def _moved(comm, home: set, state) -> int:
    """Particles that live on another rank than at the start, summed over
    the ranks."""
    (moved,), _ = comm.reduce([len(set(state.pid[state.valid].tolist()) - home)], [0])
    return int(moved)


def brick_checks(comm: BrickComm, cases: dict) -> None:
    """Eight ranks, spawned as a (2, 2, 2) grid: the coordinate map, the
    three grids against the single process, diagonal migration, the click,
    halo overflow and balanced planes (tests/test_mesh3d.py's cases)."""
    cfg = sparse_cfg()
    assert comm.shape == (2, 2, 2)
    assert comm.coords == tuple(int(c) for c in np.unravel_index(comm.rank, comm.shape))
    for ax in range(3):
        line = comm.axis(ax)
        assert (line.rank, line.size) == (comm.coords[ax], 2)
        below, above = line._peers()
        assert (below is None) == (line.rank == 0) and (above is None) == (line.rank == 1)
        peer = below if above is None else above
        assert np.unravel_index(peer, comm.shape)[ax] != comm.coords[ax]
        # the peer lies on this rank's line: the other two coordinates agree
        assert [c for i, c in enumerate(np.unravel_index(peer, comm.shape)) if i != ax] == \
            [c for i, c in enumerate(comm.coords) if i != ax]

    # ---- the three grids, 10 steps against the single process
    for shape in GRIDS:
        grid = comm if shape == comm.shape else BrickComm(comm.device, comm.group, shape)
        mcfg = mcfg_of(shape)
        state = distribute_state_3d(_as_state(cases["rand"]), cfg, mcfg, grid)
        state, aux = _advance(make_mesh3d_step(cfg, mcfg, grid), state, 10)
        _clean(aux, cfg.num_particles)
        _close(collect_state(state, cfg.num_particles, grid), cases["rand10"])
        pid = state.pid[state.valid]
        assert pid.unique().numel() == pid.numel()
        if shape == (8, 1, 1):
            # an axis of extent 1: no peers, zeros back, nothing sent
            for ax in (1, 2):
                assert grid.axis(ax)._peers() == (None, None)
                got = grid.axis(ax).exchange([torch.ones(3)], [torch.ones(2, dtype=torch.int32)])
                assert not got[0][0].any() and not got[1][0].any()

    # ---- a dense blob across every face: interactions through the halos
    mcfg = mcfg_of((2, 2, 2))
    state = distribute_state_3d(_as_state(cases["blob"]), cfg, mcfg, comm)
    assert int(state.valid.sum()) == cfg.num_particles // 8
    state, aux = _advance(make_mesh3d_step(cfg, mcfg, comm), state, 10)
    _clean(aux, cfg.num_particles)
    assert int(aux.max_halo_send) > 0
    _close(collect_state(state, cfg.num_particles, comm), cases["blob10"])

    # ---- diagonal ±2.5: brick-corner crossers reach their owners
    for planes in (None, balanced_brick_planes(cases["diag"]["position"], cfg, comm.shape)):
        mcfg = mcfg_of(comm.shape, axis_planes=planes)
        state = distribute_state_3d(_as_state(cases["diag"]), cfg, mcfg, comm)
        home = set(state.pid[state.valid].tolist())
        state, aux = _advance(make_mesh3d_step(cfg, mcfg, comm), state, 15)
        _clean(aux, cfg.num_particles)
        assert int(aux.max_migration_send) > 0 and _moved(comm, home, state) > 0
        assert int(state.valid.sum()) > 0  # every rank owns someone
        _close(collect_state(state, cfg.num_particles, comm), cases["diag15"])

    # ---- the click at the box centre, one step
    mcfg = mcfg_of(comm.shape)
    state = distribute_state_3d(_as_state(cases["rand"]), cfg, mcfg, comm)
    state, _ = _advance(make_mesh3d_step(cfg, mcfg, comm), state, 1, click_at=0, click=JCLICK)
    got = collect_state(state, cfg.num_particles, comm)
    np.testing.assert_allclose(got["velocity"], cases["click1"]["velocity"], rtol=1e-4, atol=1e-4)

    # ---- tiny halo buffers on the dense grid sheet: overflow is counted
    dense = default_config(4096, chunk_size=4096)
    small = Mesh3DConfig(comm.shape, 4096, (8, 8, 8), (128, 128, 128))
    whole = init_state(dense, device="cpu")
    state = distribute_state_3d(whole, dense, small, comm)
    step = make_mesh3d_step(dense, small, comm)
    total = 0
    for _ in range(5):
        state, aux = step(state)
        total += int(aux.halo_overflow)
    assert total > 0


def jax_brick_checks(comm: BrickComm, payload: dict) -> None:
    """Four ranks as a (1, 2, 2) grid against the JAX package's brick step:
    the same distributed state in, per rank the same live rows and the
    same nine counters out after every step."""
    cfg = sparse_cfg()
    mcfg = Mesh3DConfig(**payload["mcfg"])
    state = dist_state_from_numpy(payload["start"], comm.rank, mcfg, "cpu")
    step = make_mesh3d_step(cfg, mcfg, comm)
    home = set(state.pid[state.valid].tolist())
    halo = migrated = 0
    for want, want_aux in zip(payload["states"], payload["auxs"]):
        state, aux = step(state)
        assert [int(a) for a in aux] == want_aux, (aux, want_aux)
        halo, migrated = halo + int(aux.max_halo_send), migrated + int(aux.max_migration_send)
        ref = dist_state_from_numpy(want, comm.rank, mcfg, "cpu")
        assert int(state.valid.sum()) == int(ref.valid.sum())

        def live_rows(s):
            order = torch.argsort(s.pid[s.valid])
            return [a[s.valid][order].numpy() for a in (s.pid, s.position, s.velocity)]

        for got, exp in zip(live_rows(state), live_rows(ref)):
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    assert halo > 0 and migrated > 0 and _moved(comm, home, state) > 0


def slice_major_checks(comm: SlabComm, cases: dict) -> None:
    """Four ranks whose slices interleave (0, 1, 0, 1): the line is
    slice-major, (0, 2, 1, 3), the step over it matches the single process,
    and DistSimulator builds its line through the topology."""
    cfg = sparse_cfg()
    topo = make_multislice_mesh(comm.size, slices=[r % 2 for r in range(comm.size)])
    assert topo.order == (0, 2, 1, 3) and topo.dcn_boundary_pairs() == [(1, 2)]
    line = SlabComm(comm.device, comm.group, topo.order)
    assert line.rank == topo.order.index(comm.rank)
    dcfg = DistConfig(comm.size, cfg.padded_num_particles, 256, 128)
    state = distribute_state(_as_state(cases["drift"]), cfg, dcfg, line)
    home = set(state.pid[state.valid].tolist())
    state, aux = _advance(make_sharded_step(cfg, dcfg, line), state, 20)
    _clean(aux, cfg.num_particles)
    assert _moved(line, home, state) > 0
    _close(collect_state(state, cfg.num_particles, line), cases["drift20"])

    sim = DistSimulator(cfg, comm, n_slices=2, device="cpu")
    assert sim.topology.n_slices == 2 and sim.topology.dcn_boundary_pairs() == [(1, 2)]
    assert sim.comm.order == (0, 1, 2, 3)


# ------------------------------------------------------------ DistSimulator
SIM = dict(random_init=True, device="cpu")


def _sim(comm, cfg, mesh, seed=21, **kw):
    return DistSimulator(cfg, comm, seed=seed, mesh_shape=mesh, **{**SIM, **kw})


def _same_positions(a, b, tol):
    np.testing.assert_allclose(a.get_position(), b.get_position(), rtol=tol, atol=tol)


def simulator_checks(comm, cases: dict, brick) -> None:
    """tests/test_dist_simulator.py's cases for one rank count, for the
    z-slab line and for the brick grid `brick` (None: z only)."""
    cfg = sparse_cfg()
    meshes = (None,) if brick is None else (None, brick)
    for mesh in meshes:
        what = f"mesh {mesh}"
        # ---- the single card, 5 steps
        sim = _sim(comm, cfg, mesh)
        sim.setup()
        for _ in range(5):
            sim.simulate()
        assert sim.num_particles_alive() == cfg.num_particles, what
        np.testing.assert_allclose(sim.get_position(), cases["sim5"], rtol=1e-4, atol=1e-4)

        # ---- the timed phases are the step, and every phase took time
        from tpusph_torch.bench.times import Times

        a, b = _sim(comm, cfg, mesh, seed=7), _sim(comm, cfg, mesh, seed=7)
        a.setup()
        b.setup()
        times = Times()
        for _ in range(3):
            a.simulate_and_time(times)
            b.simulate()
        assert times.iters == 3 and min(times.build_grid, times.sph_update, times.memcpy) > 0
        _same_positions(a, b, 1e-6)

        # ---- run(4, chunk=2) is four simulate() steps
        a, b = _sim(comm, cfg, mesh), _sim(comm, cfg, mesh)
        a.setup()
        b.setup()
        a.run(4, chunk=2)
        for _ in range(4):
            b.simulate()
        assert a.num_particles_alive() == cfg.num_particles
        _same_positions(a, b, 1e-6)

        # ---- balance by default: planes from the initial occupancy
        planes = a.dcfg.slab_planes if mesh is None else a.dcfg.axis_planes
        if comm.size == 1:
            assert planes is None
        elif mesh is None:
            assert len(planes) == comm.size + 1 and planes[0] == 0
            assert planes[-1] == cfg.num_cells_per_dim
            legacy = _sim(comm, cfg, mesh, balance=False)
            legacy.setup()
            assert legacy.dcfg.slab_planes is None
        else:
            assert [len(p) for p in planes] == [m + 1 for m in mesh]

        # ---- right_size shrinks toward the measured peaks, keeps the
        # planes, and leaves the trajectory as it was
        a, b = _sim(comm, cfg, mesh), _sim(comm, cfg, mesh)
        a.setup()
        b.setup()
        before = a.dcfg
        a.right_size(warmup_steps=3)
        assert a.dcfg.dev_capacity <= before.dev_capacity and a.dcfg.dev_capacity >= 256
        if mesh is None:
            assert a.dcfg.halo_capacity <= before.halo_capacity
            assert a.dcfg.slab_planes == before.slab_planes
        else:
            assert all(x <= y for x, y in zip(a.dcfg.halo_capacity, before.halo_capacity))
            assert a.dcfg.axis_planes == before.axis_planes
        a.run(3)
        b.run(3)
        _same_positions(a, b, 1e-6)

        # ---- a checkpoint of one engine resumes on the other
        other = brick if mesh is None else None
        if other is not None:
            host = a.to_host_state()
            assert host.position.shape == (cfg.padded_num_particles, 3)
            assert int(host.valid.sum()) == cfg.num_particles
            c = _sim(comm, cfg, other)
            c.setup(host)
            c.run(2)
            a.run(2)
            _same_positions(a, c, 1e-5)

    # ---- capacity growth, step by step and inside a chunk
    if comm.size > 1:
        tiny = DistConfig(comm.size, 512, 8, 64)
        a = _sim(comm, cfg, None, seed=2, dcfg=tiny)
        a.setup()
        a.simulate()
        assert a.dcfg.halo_capacity > 8 and a.num_particles_alive() == cfg.num_particles
        a = _sim(comm, cfg, None, seed=2, dcfg=tiny)
        a.setup()
        a.run(3)
        assert a.dcfg.halo_capacity > 8
        b = _sim(comm, cfg, None, seed=2)
        b.setup()
        b.run(3)
        _same_positions(a, b, 1e-6)
    if brick is not None or comm.size == 1:
        # the brick grid's capacities come from default_mesh3d_config only
        grid = brick or (1, 1, 1)
        dense = default_config(512, chunk_size=512)
        a = DistSimulator(dense, comm, mesh_shape=grid, device="cpu")
        a.dcfg = Mesh3DConfig(grid, a.dcfg.dev_capacity, (8, 8, 8), a.dcfg.migration_capacity)
        a._rebuild_step()
        a.setup()
        a.simulate()
        assert min(a.dcfg.halo_capacity) > 8 and a.last_aux.halo_overflow == 0
        assert a.num_particles_alive() == dense.num_particles

    # ---- rebalance: a +z drift piles the fluid against the far wall; the
    # re-partition leaves the trajectory as it was, and run() triggers it
    if comm.size > 1:
        def make():
            s = _sim(comm, cfg, None, seed=3)
            s.setup()
            host = s.to_host_state()
            host.velocity[:, 2] = 3.0
            s.setup(host)
            return s

        a, b = make(), make()
        a.run(8, chunk=4)
        b.run(8, chunk=4)
        planes0 = a.dcfg.slab_planes
        if a.rebalance(min_gain=0.0):
            assert a.dcfg.slab_planes != planes0
        a.run(6, chunk=3)
        b.run(6, chunk=3)
        assert a.num_particles_alive() == cfg.num_particles
        _same_positions(a, b, 1e-5)
        c = make()
        c.run(14, chunk=2, rebalance_above=1.0)
        assert c.num_particles_alive() == cfg.num_particles
        _same_positions(c, b, 1e-5)


def jax_simulator_checks(comm: SlabComm, payload: dict) -> None:
    """Two ranks against tpusph's DistSimulator on two devices, from the
    same initial state: setup's balanced planes equal, and the positions
    by pid after every one of the simulate() steps."""
    cfg = sparse_cfg()
    sim = DistSimulator(cfg, comm, device="cpu")
    sim.setup(state_from_numpy(payload["start"], "cpu"))
    assert sim.dcfg.slab_planes == tuple(payload["planes"]), (sim.dcfg, payload["planes"])
    for want in payload["positions"]:
        sim.simulate()
        np.testing.assert_allclose(sim.get_position(), want, rtol=1e-5, atol=1e-5)
    assert sim.last_aux.halo_overflow == 0 and sim.num_particles_alive() == cfg.num_particles



# ------------------------------------------------ segmented graphs, peers


def brick_graph_checks(comm: BrickComm, cases: dict) -> None:
    """The brick engine's graphed entry points against their eager paths
    on this grid (the blob drifting ±3 along y and x, so rows cross the y
    and x faces; ±3 along z too on a grid split along z), and the chains:
    one exchange a halo phase and a hop along each axis that has a peer,
    the step ending at the reduce."""
    from torch_dist_ranks import _counts, graphed_against_eager

    from tpusph_torch.dist.mesh3d import make_mesh3d_run, make_mesh3d_timed

    cfg = sparse_cfg()
    arrays = planar_drift(cases["blob"])
    arrays["velocity"][:, 2] = arrays["velocity"][:, 0]
    mcfg = mcfg_of(comm.shape)
    start = distribute_state_3d(_as_state(arrays), cfg, mcfg, comm)
    got = {name: graphs.structures() for name, graphs in graphed_against_eager(
        comm, cfg, mcfg, start, (make_mesh3d_step, make_mesh3d_timed, make_mesh3d_run)).items()}
    axes = sum(m > 1 for m in comm.shape)  # the axes that have a peer
    for clicked in (False, True):
        step = got["step"][("step", clicked)]
        assert step[-1] == "reduce", step
        assert _counts(step) == {"segment": 2 * axes + 1, "exchange": 2 * axes, "reduce": 1}
    timed = got["timed"]
    assert _counts(timed[("build",)]) == {"segment": axes + 1, "exchange": axes, "reduce": 1}
    assert _counts(timed[("update",)]) == {"segment": axes + 2, "exchange": axes, "reduce": 1}
    assert _counts(got["run"][("run",)]) == {"segment": 2 * axes + 1, "exchange": 2 * axes,
                                             "reduce": 0}


def jax_graph_brick_checks(comm: BrickComm, payload: dict) -> None:
    """Four ranks as a (1, 2, 2) grid: the graphed step and run against the
    JAX package's jitted `make_mesh3d_step` and `make_mesh3d_run` from the
    same distributed state, per rank the same live rows (rtol 1e-5, atol
    1e-6) and the same nine counters after every step and after the run."""
    from torch_dist_ranks import _live_rows_close

    from tpusph_torch.dist.mesh3d import make_mesh3d_run

    cfg = sparse_cfg()
    mcfg = Mesh3DConfig(**payload["mcfg"])
    start = dist_state_from_numpy(payload["start"], comm.rank, mcfg, "cpu")
    step = make_mesh3d_step(cfg, mcfg, comm)
    state, migrated = start, 0
    for want, want_aux in zip(payload["states"], payload["auxs"]):
        state, aux = step(state)
        assert [int(a) for a in aux] == want_aux, (aux, want_aux)
        _live_rows_close(state, dist_state_from_numpy(want, comm.rank, mcfg, "cpu"))
        migrated += int(aux.max_migration_send)
    assert migrated > 0
    state, aux = make_mesh3d_run(cfg, mcfg, comm, len(payload["states"]))(start)
    assert [int(a) for a in aux] == payload["run_aux"], (aux, payload["run_aux"])
    _live_rows_close(state, dist_state_from_numpy(payload["run"], comm.rank, mcfg, "cpu"))
