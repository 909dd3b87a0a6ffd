"""What every rank of `tests/test_torch_dist.py` runs. It lives in a
module of its own, with no JAX import, because `spawn_ranks` starts fresh
processes that import the module of the function they are given.

`make_cases` builds, in the parent, the whole states the ranks start from
and the single-process results they are held against (numpy arrays, so
they pickle). `rank_checks(comm, cases)` is one rank's share of all the
checks of its rank count; a failing assert in any rank fails the spawn.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from tpusph_torch.core.config import BOX_MAX_Y, BOX_MIN_X, default_config
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FluidState, dist_state_from_numpy
from tpusph_torch.dist.sharded import (
    DistAux,
    DistConfig,
    DistState,
    balanced_slab_planes,
    collect_state,
    distribute_state,
    make_sharded_run,
    make_sharded_step,
    make_sharded_timed,
)
from tpusph_torch.engine.step import make_step
from tpusph_torch.interact.impulse import make_impulse

# the reference's bars (tests/test_dist.py:71-72)
POS = dict(rtol=1e-4, atol=1e-4)
VEL = dict(rtol=1e-3, atol=1e-3)
OVERFLOWS = ("halo_overflow", "migration_overflow", "window_overflow", "misrouted")
# a click at the box's lower left corner: cell (0, 1), next to the grid
# state's particles (cells x = 1, y = 1 .. 9)
CLICK = (BOX_MIN_X + 1, BOX_MAX_Y - 1)
CLICK_STEP = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A test module that imports this fixture runs one thread in its own
    process too, as its ranks do: while ranks keep every core busy, a
    multithreaded op waits at every barrier for threads the scheduler
    cannot run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sparse_cfg():
    """The reference's fixture (tests/test_dist.py:31-33): 512 particles,
    random init seed 13. They are too sparse to interact."""
    return default_config(512, chunk_size=512)


def dense_cfg():
    """1,024 particles of the grid init: one x-plane of the 0.9h lattice,
    10 rows in y and the box's whole depth in z, so every slab has
    neighbours across both of its faces."""
    return default_config(1024, chunk_size=1024)


def _as_numpy(state: FluidState) -> dict:
    return {f: getattr(state, f).numpy() for f in ("position", "velocity", "valid")}


def _as_state(arrays: dict):
    return types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def drifting(arrays: dict) -> dict:
    """±3 z drift, so that particles cross slab faces (tests/test_dist.py:85-88)."""
    vel = np.zeros_like(arrays["velocity"])
    vel[:, 2] = np.where(np.arange(len(vel)) % 2 == 0, 3.0, -3.0)
    return dict(arrays, velocity=vel)


def single_process(cfg, arrays: dict, steps: int, click_at=None, click=CLICK) -> dict:
    """{position, velocity} of the live particles after `steps` steps of
    the port's own `step_cell_list`, with `click` after step `click_at`."""
    n = cfg.padded_num_particles
    z3, z1 = torch.zeros((n, 3)), torch.zeros(n)
    state = FluidState(
        torch.from_numpy(arrays["position"].copy()), torch.from_numpy(arrays["velocity"].copy()),
        z3, z1, z1, torch.from_numpy(arrays["valid"].copy()),
    )
    step, impulse = make_step(cfg, "cell_list", "cpu"), make_impulse(cfg)
    for k in range(steps):
        pre = state.position
        state, _ = step(state)
        if k == click_at:
            state = impulse(state, pre, click)
    m = cfg.num_particles
    return {"position": state.position.numpy()[:m], "velocity": state.velocity.numpy()[:m]}


def make_cases() -> dict:
    sparse, dense = sparse_cfg(), dense_cfg()
    rand = _as_numpy(init_state(sparse, random_init=True, seed=13, device="cpu"))
    grid = _as_numpy(init_state(dense, device="cpu"))
    return {
        "rand": rand,
        "rand10": single_process(sparse, rand, 10),
        "drift": drifting(rand),
        "drift20": single_process(sparse, drifting(rand), 20),
        "grid": grid,
        "grid10": single_process(dense, grid, 10),
        "grid_click": single_process(dense, grid, 3, click_at=CLICK_STEP),
        "grid3": single_process(dense, grid, 3),
    }


def _clean(aux: DistAux, n: int) -> None:
    for name in OVERFLOWS:
        assert int(getattr(aux, name)) == 0, (name, aux)
    assert int(aux.num_particles) == n, aux


def _close(got: dict, want: dict) -> None:
    assert not np.isnan(got["position"]).any()  # every particle accounted for
    np.testing.assert_allclose(got["position"], want["position"], **POS)
    np.testing.assert_allclose(got["velocity"], want["velocity"], **VEL)


def _dcfg(comm, cfg, **over) -> DistConfig:
    base = dict(
        n_devices=comm.size, dev_capacity=cfg.padded_num_particles, halo_capacity=256,
        migration_capacity=128,
    )
    return DistConfig(**{**base, **over})


def _advance(step, state, steps: int):
    aux = None
    for _ in range(steps):
        state, aux = step(state)
    return state, aux


def _same(a: DistState, b: DistState) -> None:
    for x, y, name in zip(a, b, DistState._fields):
        assert torch.equal(x, y), name


def rank_checks(comm, cases: dict) -> None:
    sparse, dense = sparse_cfg(), dense_cfg()
    D = comm.size

    # ---- 10 steps against the single process, then conservation over 20
    for cfg, name in ((sparse, "rand"), (dense, "grid")):
        dcfg = _dcfg(comm, cfg)
        step = make_sharded_step(cfg, dcfg, comm)
        state = distribute_state(_as_state(cases[name]), cfg, dcfg, comm)
        assert int(state.valid.sum()) < cfg.num_particles or D == 1  # really split
        state, aux = _advance(step, state, 10)
        _clean(aux, cfg.num_particles)
        _close(collect_state(state, cfg.num_particles, comm), cases[name + "10"])
        pid = state.pid[state.valid]
        assert pid.unique().numel() == pid.numel() and int(pid.min()) >= 0
        if name == "grid":
            assert int(aux.max_halo_send) > 0  # the halos are not empty
        state, aux = _advance(step, state, 10)
        _clean(aux, cfg.num_particles)

    # ---- migration: with the z drift some pid changes rank, and the
    # physics still matches the single process
    dcfg = _dcfg(comm, sparse)
    step = make_sharded_step(sparse, dcfg, comm)
    state = distribute_state(_as_state(cases["drift"]), sparse, dcfg, comm)
    home = set(state.pid[state.valid].tolist())
    sent = 0
    for _ in range(20):
        state, aux = step(state)
        _clean(aux, sparse.num_particles)
        sent = max(sent, int(aux.max_migration_send))
    assert sent > 0
    arrived = set(state.pid[state.valid].tolist()) - home
    (moved,), _ = comm.reduce([len(arrived)], [0])
    assert int(moved) > 0  # some particle lives on another rank now
    _close(collect_state(state, sparse.num_particles, comm), cases["drift20"])

    if D == 4:
        # ---- balanced planes: the splice path at planes that do not
        # divide the box evenly
        for cfg, name in ((sparse, "rand"), (dense, "grid")):
            planes = balanced_slab_planes(cases[name]["position"][:, 2], cfg, D)
            if name == "rand":
                assert planes != tuple(range(0, 101, 25))
            dcfg = _dcfg(comm, cfg, slab_planes=planes)
            step = make_sharded_step(cfg, dcfg, comm)
            state = distribute_state(_as_state(cases[name]), cfg, dcfg, comm)
            state, aux = _advance(step, state, 10)
            _clean(aux, cfg.num_particles)
            _close(collect_state(state, cfg.num_particles, comm), cases[name + "10"])
        # and under migration
        planes = balanced_slab_planes(cases["drift"]["position"][:, 2], sparse, D)
        dcfg = _dcfg(comm, sparse, slab_planes=planes)
        step = make_sharded_step(sparse, dcfg, comm)
        state = distribute_state(_as_state(cases["drift"]), sparse, dcfg, comm)
        state, aux = _advance(step, state, 20)
        _clean(aux, sparse.num_particles)
        _close(collect_state(state, sparse.num_particles, comm), cases["drift20"])

    if D == 2:
        dcfg = _dcfg(comm, dense)
        start = distribute_state(_as_state(cases["grid"]), dense, dcfg, comm)
        step = make_sharded_step(dense, dcfg, comm)

        # ---- the other backend: the tile passes (everything else here runs
        # `kernels`, on the CPU the kernels' plain versions)
        tstate, taux = _advance(make_sharded_step(dense, dcfg, comm, "cell_list"), start, 3)
        _clean(taux, dense.num_particles)
        _close(collect_state(tstate, dense.num_particles, comm), cases["grid3"])

        # ---- make_sharded_run(5) is five steps
        five, aux5 = _advance(step, start, 5)
        ran, aux_run = make_sharded_run(dense, dcfg, comm, 5)(start)
        _same(ran, five)
        _clean(aux_run, dense.num_particles)
        assert int(aux_run.max_halo_send) == int(aux5.max_halo_send) > 0

        # ---- the two timed phases are one step without a click
        build, update = make_sharded_timed(dense, dcfg, comm)
        one, aux1 = step(start)
        timed, aux_t = update(*build(start))
        _same(timed, one)
        assert [int(a) for a in aux_t] == [int(a) for a in aux1]

        # ---- a click is the single process's click
        state = start
        for k in range(3):
            state, aux = step(state, click_px=CLICK if k == CLICK_STEP else None)
        _clean(aux, dense.num_particles)
        got = collect_state(state, dense.num_particles, comm)
        _close(got, cases["grid_click"])
        assert np.abs(got["velocity"] - cases["grid3"]["velocity"]).max() > 1.0
        state = start
        for k in range(3):
            state, _ = step(state, click_px=CLICK, click_active=False)
        _close(collect_state(state, dense.num_particles, comm), cases["grid3"])

        # ---- a halo buffer that is too small is reported, nothing raises
        small = _dcfg(comm, dense, halo_capacity=8)
        state = distribute_state(_as_state(cases["grid"]), dense, small, comm)
        total = 0
        for _ in range(3):
            state, aux = make_sharded_step(dense, small, comm)(state)
            total += int(aux.halo_overflow)
        assert total > 0
        # likewise migration buffers
        tight = _dcfg(comm, sparse, migration_capacity=8)
        fast = dict(cases["drift"], velocity=cases["drift"]["velocity"] * 100)
        state = distribute_state(_as_state(fast), sparse, tight, comm)
        state, aux = make_sharded_step(sparse, tight, comm)(state)
        assert int(aux.migration_overflow) > 0


def jax_checks(comm, payload: dict) -> None:
    """Two ranks against the JAX package's sharded step: the same
    distributed state in, per rank the same live rows and the same nine
    counters out after every step."""
    cfg = sparse_cfg()
    dcfg = DistConfig(**payload["dcfg"])
    state = dist_state_from_numpy(payload["start"], comm.rank, dcfg, "cpu")
    step = make_sharded_step(cfg, dcfg, comm, "cell_list")
    halo = migrated = 0
    for want, want_aux in zip(payload["states"], payload["auxs"]):
        state, aux = step(state)
        assert [int(a) for a in aux] == want_aux, (aux, want_aux)
        halo, migrated = halo + int(aux.max_halo_send), migrated + int(aux.max_migration_send)
        ref = dist_state_from_numpy(want, comm.rank, dcfg, "cpu")
        assert int(state.valid.sum()) == int(ref.valid.sum())

        def live_rows(s):
            order = torch.argsort(s.pid[s.valid])
            return [a[s.valid][order].numpy() for a in (s.pid, s.position, s.velocity)]

        for got, exp in zip(live_rows(state), live_rows(ref)):
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    assert halo > 0 and migrated > 0


def dryrun_tight_halo(comm) -> None:
    """The dry run's z-slab leg (`graft_entry.slab_leg`) on its own state
    with halo buffers of 8 rows: the halo overflow counter goes non-zero
    on the first step, and the leg's check must raise."""
    from tpusph_torch import graft_entry

    cfg = graft_entry.dryrun_config()
    dcfg = DistConfig(n_devices=comm.size, dev_capacity=8192, halo_capacity=8,
                      migration_capacity=256)
    graft_entry.slab_leg(comm, cfg, dcfg, graft_entry.dryrun_state(cfg), "kernels", 1, 0,
                         "tight")


def _trajectory(step, state, steps: int) -> list:
    """(DistState, counters as ints) after each of `steps` steps."""
    out = []
    for _ in range(steps):
        state, aux = step(state)
        out.append((state, [int(a) for a in aux]))
    return out


def skip_checks(comm, cases: dict, steps: int) -> None:
    """The migration-free sort skip against TPUSPH_DIST_FORCE_MIGSORT=1 on
    this rank count, on the grid init (no slab-crossers) and on the
    drifting random state (crossers): every row of every field and the
    nine counters equal after every step; the branch counters say which
    ran, summed over the ranks."""
    import os

    from tpusph_torch.dist import sharded

    for cfg, name in ((dense_cfg(), "grid"), (sparse_cfg(), "drift")):
        dcfg = _dcfg(comm, cfg)
        start = distribute_state(_as_state(cases[name]), cfg, dcfg, comm)
        step = make_sharded_step(cfg, dcfg, comm)
        runs, counts = {}, {}
        for forced in ("1", "0"):
            os.environ["TPUSPH_DIST_FORCE_MIGSORT"] = forced
            sharded.migration_sorts = sharded.migration_skips = 0
            runs[forced] = _trajectory(step, start, steps)
            (sorts, skips), _ = comm.reduce(
                [sharded.migration_sorts, sharded.migration_skips], [0]
            )
            counts[forced] = (int(sorts), int(skips))
        os.environ.pop("TPUSPH_DIST_FORCE_MIGSORT")
        for k, ((a, aux_a), (b, aux_b)) in enumerate(zip(runs["1"], runs["0"])):
            assert aux_a == aux_b, (name, k, aux_a, aux_b)
            for x, y, field in zip(a, b, DistState._fields):
                assert torch.equal(x, y), (name, k, field)
        _clean(DistAux(*runs["0"][-1][1]), cfg.num_particles)
        assert counts["1"] == (comm.size * steps, 0), counts
        sorts, skips = counts["0"]
        assert sorts + skips == comm.size * steps, counts
        crossed = sum(aux[-1] > 0 for _, aux in runs["0"])  # max_migration_send
        if name == "grid":
            assert crossed == 0 and counts["0"] == (0, comm.size * steps), counts
        else:
            assert crossed > 0 and sorts > 0 and skips > 0, (counts, crossed)


def jax_skip_checks(comm, payload: dict) -> None:
    """Two ranks against tpusph's `make_sharded_run` from the same
    distributed state, the skip live on both sides: positions and
    velocities by pid within 1e-5 after the run, and both branches of the
    migration step taken on this side."""
    from tpusph_torch.dist import sharded

    cfg = sparse_cfg()
    dcfg = DistConfig(**payload["dcfg"])
    state = dist_state_from_numpy(payload["start"], comm.rank, dcfg, "cpu")
    sharded.migration_sorts = sharded.migration_skips = 0
    run = make_sharded_run(cfg, dcfg, comm, payload["steps"], "cell_list")
    state, aux = run(state)
    assert [int(a) for a in aux] == payload["aux"], (aux, payload["aux"])
    got = collect_state(state, cfg.num_particles, comm)
    for f in ("position", "velocity"):
        np.testing.assert_allclose(got[f], payload[f], rtol=1e-5, atol=1e-5)
    (sorts, skips), _ = comm.reduce([sharded.migration_sorts, sharded.migration_skips], [0])
    assert int(sorts) > 0 and int(skips) > 0, (sorts, skips)


def checkpoint_save(comm, path: str, ref_path: str) -> None:
    """tpusph's checkpoint round trip, the saving side: `DistSimulator` on
    this rank count from seed-13 random init, 2 steps, `save_dist_state`,
    then 2 more steps; rank 0 keeps the uninterrupted positions."""
    from tpusph_torch.core.io import save_dist_state
    from tpusph_torch.dist.simulator import DistSimulator

    cfg = sparse_cfg()
    sim = DistSimulator(cfg, comm, random_init=True, seed=13, device="cpu")
    sim.setup()
    sim.run(2)
    save_dist_state(path, sim.state, sim.cfg, sim.dcfg, sim.comm)
    sim.run(2)
    position = sim.get_position()  # a collective: every rank calls it
    if comm.rank == 0:
        np.save(ref_path, position)


def checkpoint_resume(comm, path: str, ref_path: str) -> None:
    """The resuming side: load the checkpoint onto this rank count (a
    DistConfig of its own, the default heuristics), 2 steps, positions by
    pid within 1e-5 of the uninterrupted run."""
    from tpusph_torch.core.io import load_dist_state
    from tpusph_torch.dist.simulator import default_dist_config

    state, cfg, dcfg = load_dist_state(path, comm)
    assert cfg == sparse_cfg() and dcfg == default_dist_config(cfg, comm.size), dcfg
    state, aux = make_sharded_run(cfg, dcfg, comm, 2)(state)
    _clean(aux, cfg.num_particles)
    got = collect_state(state, cfg.num_particles, comm)["position"]
    np.testing.assert_allclose(got, np.load(ref_path), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ segmented graphs, peers


def _same_aux(a: DistAux, b: DistAux) -> None:
    """The nine counters equal, dtypes included (the graphed ones live on
    the rank's device, a host-staged group's eager ones on the host)."""
    assert [int(x) for x in a] == [int(x) for x in b], (a, b)
    assert [x.dtype for x in a] == [x.dtype for x in b], (a, b)


def graphed_against_eager(comm, cfg, dcfg, start, makers, steps: int = 3) -> dict:
    """Each graphed entry point of `makers` = (make_step, make_timed,
    make_run) against its `.eager` from `start`, bit for bit after each of
    `steps` calls, the nine counters and their dtypes included: the step
    (a click at the second), the timed stages, and `run(steps)`. Returns
    {entry: its `RankGraphs`} ("step", "timed", "run")."""
    make_step, make_timed, make_run = makers
    step = make_step(cfg, dcfg, comm)
    build, update = make_timed(cfg, dcfg, comm)
    a = b = c = d = start
    for k in range(steps):
        click = CLICK if k == CLICK_STEP else None
        (a, aux_a), (b, aux_b) = step(a, click), step.eager(b, click)
        _same(a, b)
        _same_aux(aux_a, aux_b)
        (c, aux_c), (d, aux_d) = update(*build(c)), update.eager(*build.eager(d))
        _same(c, d)
        _same_aux(aux_c, aux_d)
    _clean(aux_a, cfg.num_particles)
    run = make_run(cfg, dcfg, comm, steps)
    for _ in range(2):  # the capture, then a replay of the same run
        (a, aux_a), (b, aux_b) = run(start), run.eager(start)
        _same(a, b)
        _same_aux(aux_a, aux_b)
    _same(a, d)  # the run is `steps` steps
    return {"step": step.graphs, "timed": build.graphs, "run": run.graphs}


def _counts(structure) -> dict:
    return {kind: structure.count(kind) for kind in ("segment", "exchange", "reduce")}


def slab_graph_checks(comm, cases: dict) -> None:
    """The z-slab engine's graphed entry points against their eager paths
    on this rank count (the grid init drifting ±3 along z, so rows cross
    the faces), and the chain of a step: three segments, split at the two
    exchanges and ending at the reduce; the run one step's segments and a
    fold that reduces once."""
    from tpusph_torch.dist import sharded

    cfg = dense_cfg()
    dcfg = _dcfg(comm, cfg)
    start = distribute_state(_as_state(drifting(cases["grid"])), cfg, dcfg, comm)
    got = {name: graphs.structures() for name, graphs in graphed_against_eager(
        comm, cfg, dcfg, start,
        (make_sharded_step, make_sharded_timed, make_sharded_run)).items()}
    forced = sharded._force_migsort()
    for clicked in (False, True):
        step = got["step"][("step", clicked, False, forced)]
        assert step == ["segment", "exchange", "segment", "exchange", "segment", "reduce"], step
    timed = got["timed"]
    assert _counts(timed[("build", False, forced)]) == {"segment": 2, "exchange": 1, "reduce": 1}
    assert _counts(timed[("update", False, forced)]) == {"segment": 3, "exchange": 1, "reduce": 1}
    run = got["run"]
    assert _counts(run[("run", False, forced)]) == {"segment": 3, "exchange": 2, "reduce": 0}
    assert run[("fold", False, forced)] == ["segment", "reduce", "segment"]


def jax_graph_checks(comm, payload: dict) -> None:
    """Two ranks' graphed step and run against the JAX package's jitted
    `make_sharded_step` and `make_sharded_run`: the same distributed state
    in, per rank the same live rows (rtol 1e-5, atol 1e-6) and the same
    nine counters out after every step and after the run."""
    cfg = sparse_cfg()
    dcfg = DistConfig(**payload["dcfg"])
    start = dist_state_from_numpy(payload["start"], comm.rank, dcfg, "cpu")
    step = make_sharded_step(cfg, dcfg, comm)
    state, migrated = start, 0
    for want, want_aux in zip(payload["states"], payload["auxs"]):
        state, aux = step(state)
        assert [int(a) for a in aux] == want_aux, (aux, want_aux)
        _live_rows_close(state, dist_state_from_numpy(want, comm.rank, dcfg, "cpu"))
        migrated += int(aux.max_migration_send)
    assert migrated > 0
    state, aux = make_sharded_run(cfg, dcfg, comm, len(payload["states"]))(start)
    assert [int(a) for a in aux] == payload["run_aux"], (aux, payload["run_aux"])
    _live_rows_close(state, dist_state_from_numpy(payload["run"], comm.rank, dcfg, "cpu"))


def _live_rows_close(state: DistState, ref: DistState) -> None:
    """The live rows of two blocks as (pid, position, velocity) by pid, at
    rtol 1e-5 / atol 1e-6."""
    assert int(state.valid.sum()) == int(ref.valid.sum())

    def live_rows(s):
        order = torch.argsort(s.pid[s.valid])
        return [a[s.valid][order].numpy() for a in (s.pid, s.position, s.velocity)]

    for got, exp in zip(live_rows(state), live_rows(ref)):
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


def planted_read(comm) -> None:
    """Rank 0 plants a `.item()` in the graphed step's body: its capture
    guard raises `HostReadError` there, while rank 1 goes on to the
    migration exchange and waits for it."""
    from tpusph_torch.dist import sharded

    cfg = sparse_cfg()
    dcfg = _dcfg(comm, cfg)
    state = distribute_state(_as_state(_as_numpy(init_state(cfg, True, 13, "cpu"))), cfg, dcfg,
                             comm)
    if comm.rank == 0:
        integrate = sharded.integrate_fields

        def reading(*args, **kwargs):
            out = integrate(*args, **kwargs)
            out[0][0].item()
            return out

        sharded.integrate_fields = reading
    make_sharded_step(cfg, dcfg, comm)(state)


def simulator_growth(comm) -> None:
    """`DistSimulator` on this rank count from a halo and a migration
    capacity too small: each growth makes the step again, captured once
    more on every rank together; 4 steps end equal to an ample run."""
    from tpusph_torch.dist.simulator import DistSimulator
    from tpusph_torch.engine import graphs

    cfg = dense_cfg()
    ample = DistSimulator(cfg, comm, device="cpu")
    ample.setup()
    for _ in range(4):
        ample.simulate()
    tiny = DistConfig(comm.size, cfg.padded_num_particles, 8, 8)
    sim = DistSimulator(cfg, comm, dcfg=tiny, device="cpu")
    sim.setup()
    grows, grow = [], sim._grow
    sim._grow = lambda aux: (grows.append(aux), grow(aux))
    before = graphs.captures
    for _ in range(4):
        sim.simulate()
    del sim._grow  # the wrapper refers to sim: no cycle left behind
    assert grows and graphs.captures - before == len(grows) + 1, (grows, graphs.captures - before)
    assert sim.dcfg.halo_capacity > 8
    np.testing.assert_allclose(sim.get_position(), ample.get_position(), rtol=0, atol=1e-6)


def card_graph_checks(comm, cases: dict, engine: str) -> None:
    """On the card, two ranks over gloo: the slab line's or the (2, 1, 1)
    brick grid's graphed entry points against their eager paths
    (`graphed_against_eager`; every segment replays under sync debug mode
    "error"), the counters of a graphed call on the card, and each
    kernel launched once a replayed step, in the segment after the halo
    exchange; none in a run's fold. The slab step's migration branch
    (`set_if`, where the skip applies) is launched once a step, the brick
    engine's never (it has no skip)."""
    from tpusph_torch.dist import mesh3d, sharded
    from tpusph_torch.engine.graphs import COUNTED
    from tpusph_torch.kernels.graph_cond import set_if

    if engine == "slab":
        cfg = dense_cfg()
        dcfg = _dcfg(comm, cfg)
        start = distribute_state(_as_state(drifting(cases["grid"])), cfg, dcfg, comm)
        makers = (make_sharded_step, make_sharded_timed, make_sharded_run)
    else:
        cfg = sparse_cfg()
        dcfg = mesh3d.Mesh3DConfig(comm.shape, 512, (256,) * 3, (128,) * 3)
        start = mesh3d.distribute_state_3d(_as_state(cases["blob"]), cfg, dcfg, comm)
        makers = (mesh3d.make_mesh3d_step, mesh3d.make_mesh3d_timed, mesh3d.make_mesh3d_run)
    assert start.position.is_cuda
    got = graphed_against_eager(comm, cfg, dcfg, start, makers)
    kernels = [fn for fn in COUNTED if fn is not set_if]
    skip = engine == "slab" and sharded._aligned(cfg, dcfg)
    for name, graphs in got.items():
        for key, loop in graphs.loops.items():
            per_kernel = [sum(seg.get(fn, 0) for seg in loop.launches) for fn in kernels]
            want = 0 if key[0] in ("build", "fold") else 1
            assert per_kernel == [want] * len(kernels), (name, key, per_kernel)
            branches = sum(seg.get(set_if, 0) for seg in loop.launches)
            assert branches == (want if skip else 0), (name, key, branches)
            if key[0] in ("step", "run"):  # the kernels follow the halo exchange
                assert loop.structure[:2] == ["segment", "exchange"], loop.structure
                assert all(loop.launches[1].get(fn) == 1 for fn in kernels), loop.launches
    step = makers[0](cfg, dcfg, comm)
    _, aux = step(start)
    assert all(a.is_cuda for a in aux)
