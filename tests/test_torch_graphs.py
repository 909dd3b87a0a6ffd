"""The port's jitted dispatches as CUDA graphs (`tpusph_torch/engine/graphs.py`).

On the CPU a graphed entry point runs the body a card would capture, under
the capture guard: here the guard is held to raise on every host read
planted in every graphed body, the graphed entry points to the eager
path of the same function bit for bit and to tpusph's jitted
counterparts at the reference's bars, the migration-free sort skip inside
a graph (`graphs.device_if`, a conditional node on a card) to the
category sort and to tpusph's `lax.cond` run with its branch counts, and grow-and-replay to an ample run, captured once more per
growth. Small N, one thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)

from tpusph_torch.bench.times import Times  # noqa: E402
from tpusph_torch.core.config import default_config  # noqa: E402
from tpusph_torch.core.init import init_state  # noqa: E402
from tpusph_torch.core.state import FIELDS, dist_state_from_numpy  # noqa: E402
from tpusph_torch.dist import mesh3d, sharded  # noqa: E402
from tpusph_torch.dist.comm import BrickComm, SlabComm  # noqa: E402
from tpusph_torch.dist.sharded import DistConfig, collect_state, distribute_state  # noqa: E402
from tpusph_torch.dist.simulator import DistSimulator  # noqa: E402
from tpusph_torch.engine import graphs, simulator, step  # noqa: E402
from tpusph_torch.engine.graphs import GraphedLoop, HostReadError, no_host_reads  # noqa: E402
from tpusph_torch.engine.simulator import Simulator  # noqa: E402
from tpusph_torch.interact import impulse  # noqa: E402
from tpusph_torch.kernels import fused  # noqa: E402
from tpusph_torch.neighbors.cell_list import build_cell_list  # noqa: E402

CLICK = (400, 300)
READS = {
    "item": lambda t: t.sum().item(),
    "tolist": lambda t: t.tolist(),
    "cpu": lambda t: t.cpu(),
    "numpy": lambda t: t.numpy(),
    "bool": lambda t: bool(t.any()),
    "int": lambda t: int(t.sum()),
    "float": lambda t: float(t.sum()),
    "index": lambda t: list(range(10))[t.sum().long()],
}


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _ints(aux) -> list:
    return [int(x) for x in aux]


# ----------------------------------------------------------- capture guard


@pytest.mark.parametrize("read", sorted(READS))
def test_the_guard_raises_on_a_host_read(read):
    """A body that reads a tensor on the host raises in a graphed loop
    (on the CPU, as at capture on a card); the same read outside it runs."""
    t = torch.ones(4)
    READS[read](t)

    def body(inputs):
        READS[read](inputs[0])
        return [inputs[0] * 2]

    with pytest.raises(HostReadError):
        GraphedLoop(body, "cpu")([t])
    with pytest.raises(HostReadError):
        with no_host_reads(torch.device("cpu")):
            READS[read](t)


def test_the_guard_lets_a_kernel_plain_version_read():
    """A kernel's plain version stands for a launch: its own reads pass
    the guard, a read of the body around it does not."""
    cfg = default_config(512)
    st = init_state(cfg, random_init=True, seed=3, device="cpu")
    cl = build_cell_list(st.position, st.valid, cfg)
    rows = st.position[cl.perm].T.contiguous()
    want = fused.density(*rows, cl.key_sorted, cl.starts, cfg)
    with no_host_reads(torch.device("cpu")):
        got = fused.density(*rows, cl.key_sorted, cl.starts, cfg)
        with pytest.raises(HostReadError):
            got.max().item()
    assert torch.equal(got, want)


def _plant(monkeypatch, module, name):
    """Wrap `module.name` so that it reads its first output on the host."""
    orig = getattr(module, name)

    def planted(*args, **kwargs):
        out = orig(*args, **kwargs)
        first = out[0] if isinstance(out, (tuple, list)) else out
        getattr(first, "position", first).reshape(-1)[0].item()
        return out

    monkeypatch.setattr(module, name, planted)


def _slab(cfg, comm):
    dcfg = DistConfig(1, cfg.padded_num_particles, 256, 128)
    return dcfg, distribute_state(ranks._as_state(ranks._as_numpy(
        init_state(cfg, random_init=True, seed=13, device="cpu"))), cfg, dcfg, comm)


def _brick(cfg, comm):
    n = cfg.padded_num_particles  # a face with no rank behind it counts its band: halo = block
    mcfg = mesh3d.Mesh3DConfig((1, 1, 1), n, (n,) * 3, (128,) * 3)
    return mcfg, mesh3d.distribute_state_3d(ranks._as_state(ranks._as_numpy(
        init_state(cfg, random_init=True, seed=13, device="cpu"))), cfg, mcfg, comm)


def _entry(name, cfg):
    """(graphed call, eager call) of the entry point `name` on a fresh state."""
    if name in ("step", "impulse", "timed"):
        st = init_state(cfg, random_init=True, seed=3, device="cpu")
        if name == "step":
            fn = step.make_step(cfg, "kernels", "cpu")
            return lambda: fn(st), lambda: fn.eager(st)
        if name == "impulse":
            fn = impulse.make_impulse(cfg)
            return (lambda: fn(st, st.position, CLICK),
                    lambda: fn.eager(st, st.position, CLICK))
        sim = Simulator(cfg, device="cpu")
        sim.setup(st)
        return lambda: sim.simulate_and_time(Times()), None
    engine, kind = name.split("_")
    if engine == "slab":
        comm = SlabComm("cpu")
        dcfg, start = _slab(cfg, comm)
        make = {"step": sharded.make_sharded_step, "timed": sharded.make_sharded_timed,
                "run": sharded.make_sharded_run}[kind]
    else:
        comm = BrickComm("cpu")
        dcfg, start = _brick(cfg, comm)
        make = {"step": mesh3d.make_mesh3d_step, "timed": mesh3d.make_mesh3d_timed,
                "run": mesh3d.make_mesh3d_run}[kind]
    if kind == "run":
        fn = make(cfg, dcfg, comm, 2)
        return lambda: fn(start), lambda: fn.eager(start)
    if kind == "step":
        fn = make(cfg, dcfg, comm)
        return lambda: fn(start, CLICK), lambda: fn.eager(start, CLICK)
    build, update = make(cfg, dcfg, comm)
    return (lambda: update(*build(start)),
            lambda: update.eager(*build.eager(start)))


# where each body gets its planted read
PLANTS = {
    "step": (step, "_finish"), "impulse": (impulse, "click_kick"),
    "timed": (simulator, "build_phase"),
    "slab_step": (sharded, "integrate_fields"), "slab_timed": (sharded, "integrate_fields"),
    "slab_run": (sharded, "integrate_fields"), "brick_step": (mesh3d, "integrate_fields"),
    "brick_timed": (mesh3d, "integrate_fields"), "brick_run": (mesh3d, "integrate_fields"),
}


# the slab engine's bodies also through the whole machinery
GUARDED = [(name, False) for name in sorted(PLANTS)] + [
    (name, True) for name in sorted(PLANTS) if name.startswith("slab")]


@pytest.mark.parametrize("name,full", GUARDED)
def test_every_graphed_body_runs_under_the_guard(name, full, monkeypatch):
    """Every graphed entry point runs its body under the capture guard: it
    passes as it is, and a `.item()` planted in the body raises, where the
    eager path of the same function lets it through."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1" if full else "0")
    cfg = ranks.sparse_cfg()
    graphed, eager = _entry(name, cfg)
    graphed()
    _plant(monkeypatch, *PLANTS[name])
    graphed, eager = _entry(name, cfg)
    with pytest.raises(HostReadError):
        graphed()
    if eager is not None:
        eager()


# ------------------------------------------------- the single-card engine


@pytest.mark.parametrize("backend", ["allpairs", "cell_list", "kernels"])
def test_the_step_replays_the_eager_step(backend):
    """`make_step` (one replay a call on a card) equals its eager step bit
    for bit over 3 steps with a click between them; each new step object
    captures once."""
    cfg = ranks.dense_cfg()
    st = init_state(cfg, random_init=True, seed=5, device="cpu")
    fn = step.make_step(cfg, backend, "cpu")
    kick = impulse.make_impulse(cfg)
    before = graphs.captures
    a = b = st
    for k in range(3):
        (a2, aux_a), (b2, aux_b) = fn(a), fn.eager(b)
        if k == 1:
            a2, b2 = kick(a2, a.position, CLICK), kick.eager(b2, b.position, CLICK)
        a, b = a2, b2
        assert _equal([getattr(a, f) for f in FIELDS], [getattr(b, f) for f in FIELDS])
        assert _ints(aux_a) == _ints(aux_b)
    assert graphs.captures - before == 2  # the step and the impulse


@pytest.mark.parametrize("backend", ["cell_list", "kernels"])
def test_timed_and_clicked_steps_match_tpusph(backend):
    """`Simulator.simulate_and_time` (two replays a step) and
    `simulate(click=...)` (a step and an impulse replay) against tpusph's
    Simulator from the same state: positions at 1e-4, velocities at 1e-3
    after each of 4 steps, the click at the second."""
    import jax.numpy as jnp

    from tpusph.bench.times import Times as JTimes
    from tpusph.core.config import default_config as jdefault
    from tpusph.core.state import FluidState as JState
    from tpusph.engine.simulator import Simulator as JSimulator

    cfg = default_config(512)
    st = init_state(cfg, random_init=True, seed=7, device="cpu")
    arrays = {f: getattr(st, f).numpy() for f in FIELDS}
    for timed in (True, False):
        ours = Simulator(cfg, backend=backend, device="cpu")
        ours.setup(init_state(cfg, random_init=True, seed=7, device="cpu"))
        theirs = JSimulator(jdefault(512), backend="cell_list")
        theirs.setup(JState(**{f: jnp.asarray(v) for f, v in arrays.items()}))
        times, jtimes = Times(), JTimes()
        for k in range(4):
            if timed:
                ours.simulate_and_time(times)
                theirs.simulate_and_time(jtimes)
            else:
                click = CLICK if k == 1 else None
                ours.simulate(click=click)
                theirs.simulate(click=click)
            np.testing.assert_allclose(ours.state.position.numpy(),
                                       np.asarray(theirs.state.position), **ranks.POS)
            np.testing.assert_allclose(ours.state.velocity.numpy(),
                                       np.asarray(theirs.state.velocity), **ranks.VEL)
        if timed:
            assert times.iters == 4


def test_timed_phases_grow_and_replay():
    """`cell_list` from tile_cand_capacity 8: `simulate_and_time` rolls a
    step that overflowed back, grows, captures both phases again and
    replays; 4 steps end within 1e-6 of an ample run, two captures a
    growth and two at the start. `simulate()` likewise, one capture a
    growth."""
    cfg = ranks.dense_cfg()
    small = default_config(cfg.num_particles, chunk_size=cfg.chunk_size, tile_cand_capacity=8)
    ample = Simulator(cfg, backend="cell_list", device="cpu")
    ample.setup()
    for k in range(4):
        ample.simulate()
    for timed in (True, False):
        sim = Simulator(small, backend="cell_list", device="cpu")
        sim.setup()
        before, times = graphs.captures, Times()
        for k in range(4):
            if timed:
                sim.simulate_and_time(times)
            else:
                sim.simulate()
        growths = int(np.log2(sim.cfg.tile_cand_capacity // 8))
        assert growths > 0
        assert graphs.captures - before == (2 if timed else 1) * (growths + 1)
        assert int(sim.last_aux.window_overflow) == 0
        np.testing.assert_allclose(sim.state.position.numpy(), ample.state.position.numpy(),
                                   rtol=0, atol=1e-6)
        if timed:
            assert times.iters == 4


# ------------------------------------------- the sharded engines, one rank


def _jax_one_rank(kind, engine, steps, arrays, caps):
    """tpusph's jitted counterpart on one virtual device from `arrays`:
    (start arrays, [(state arrays, aux ints)] after each call)."""
    import jax
    from jax.sharding import Mesh

    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit
    from tpusph.dist import mesh3d as jmesh3d
    from tpusph.dist import sharded as jsharded

    cfg = jdefault(512, chunk_size=512)
    st = jinit(cfg)._replace(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    as_numpy = lambda d: {k: np.asarray(jax.device_get(v)) for k, v in d._asdict().items()}
    if engine == "slab":
        mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("z",))
        jcfg = jsharded.DistConfig(**caps)
        dstate = jsharded.distribute_state(st, cfg, jcfg, mesh)
        mod, make = jsharded, {"step": jsharded.make_sharded_step,
                               "timed": jsharded.make_sharded_timed,
                               "run": jsharded.make_sharded_run}[kind]
    else:
        mesh = jmesh3d.make_mesh(jax.devices("cpu")[:1], (1, 1, 1))
        jcfg = jmesh3d.Mesh3DConfig(**caps)
        dstate = jmesh3d.distribute_state_3d(st, cfg, jcfg, mesh)
        mod, make = jmesh3d, {"step": jmesh3d.make_mesh3d_step,
                              "timed": jmesh3d.make_mesh3d_timed,
                              "run": jmesh3d.make_mesh3d_run}[kind]
    start, out = as_numpy(dstate), []
    if kind == "run":
        dstate, aux = make(cfg, jcfg, mesh, steps)(dstate)
        return start, [(as_numpy(dstate), [int(a) for a in aux])]
    if kind == "timed":
        build, update = make(cfg, jcfg, mesh)
        zero, off = jax.numpy.zeros((2,), jax.numpy.int32), jax.numpy.zeros((), bool)
    else:
        fn = make(cfg, jcfg, mesh)
    for k in range(steps):
        if kind == "timed":
            inter, halo_ovf, oob, halo_send = build(dstate)
            dstate, aux = update(inter, halo_ovf, oob, halo_send, zero, off)
        else:
            dstate, aux = fn(dstate, CLICK if k == 1 else None)
        out.append((as_numpy(dstate), [int(a) for a in aux]))
    del mod
    return start, out


@pytest.mark.parametrize("engine,full", [("slab", False), ("slab", True), ("brick", True)],
                         ids=["slab_elided", "slab_full_machinery", "brick"])
@pytest.mark.parametrize("kind", ["step", "timed", "run"])
def test_one_rank_graphs_match_tpusph(engine, kind, full, monkeypatch):
    """A line of one slab rank (elided and through the whole machinery) and
    a (1, 1, 1) brick grid: the graphed step (a click at the second),
    timed stages and 3-step run against tpusph's jitted ones on one
    virtual device, from the same block (512 particles of the grid init
    with the ±3 z drift): positions and velocities by pid at the
    reference's bars and the nine counters equal after each call, the
    graphed and the eager call bit for bit (a graphed update refuses rows
    its build did not hand out), and the migration branches counted: on the
    whole machinery the skip, through `graphs.device_if`, on every torch."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1" if full else "0")
    monkeypatch.delenv("TPUSPH_DIST_FORCE_MIGSORT", raising=False)
    cfg = ranks.sparse_cfg()
    grid = ranks._as_numpy(init_state(cfg, device="cpu"))
    arrays = ranks.drifting(grid)
    steps = 3
    if engine == "slab":
        caps = dict(n_devices=1, dev_capacity=512, halo_capacity=256, migration_capacity=128)
        dcfg, comm = DistConfig(**caps), SlabComm("cpu")
        make = {"step": sharded.make_sharded_step, "timed": sharded.make_sharded_timed,
                "run": sharded.make_sharded_run}[kind]
    else:
        caps = dict(mesh_shape=(1, 1, 1), dev_capacity=512, halo_capacity=(512,) * 3,
                    migration_capacity=(128,) * 3)
        dcfg, comm = mesh3d.Mesh3DConfig(**caps), BrickComm("cpu")
        make = {"step": mesh3d.make_mesh3d_step, "timed": mesh3d.make_mesh3d_timed,
                "run": mesh3d.make_mesh3d_run}[kind]
    start_np, want = _jax_one_rank(kind, engine, steps, arrays, caps)
    start = dist_state_from_numpy(start_np, 0, dcfg, "cpu")
    counts0 = sharded.migration_counts()
    if kind == "run":
        fn = make(cfg, dcfg, comm, steps)
        calls = [(fn(start), fn.eager(start))]
    else:
        fn = make(cfg, dcfg, comm) if kind == "step" else None
        build, update = make(cfg, dcfg, comm) if kind == "timed" else (None, None)
        calls, a, b = [], start, start
        for k in range(steps):
            if kind == "step":
                click = CLICK if k == 1 else None
                (a, aux_a), (b, aux_b) = fn(a, click), fn.eager(b, click)
            else:
                (a, aux_a), (b, aux_b) = update(*build(a)), update.eager(*build.eager(b))
                with pytest.raises(ValueError, match="last build"):
                    update(*build.eager(b))  # a graphed update takes its own build's
            calls.append(((a, aux_a), (b, aux_b)))
    for ((got, aux), (eager, aux_e)), (state_np, aux_want) in zip(calls, want):
        assert _equal(got, eager) and _ints(aux) == _ints(aux_e)
        assert _ints(aux) == aux_want
        ours = collect_state(got, cfg.num_particles, comm)
        theirs = collect_state(dist_state_from_numpy(state_np, 0, dcfg, "cpu"),
                               cfg.num_particles, comm)
        ranks._close(ours, theirs)
    sorts, skips = (b - a for a, b in zip(counts0, sharded.migration_counts()))
    if engine == "slab" and full:
        # each call and its eager twin: the eager skip's host read and the
        # graph's device branch both take the skip
        assert (sorts, skips) == (0, 2 * steps)
    else:
        assert (sorts, skips) == (0, 0)
    del comm


@pytest.mark.parametrize("n_lo,n_kept,crosser", [
    (0, 0, None), (7, 40, None), (19, 101, None), (120, 8, None),
    (7, 40, "dn"), (19, 101, "up"),
])
def test_the_device_branch_is_the_category_sort(n_lo, n_kept, crosser):
    """`_graphed_order`, the branch a graph takes with no host read
    (`graphs.device_if`): the category sort's order where a row crosses a
    face, the rotation `_skip_order` gives where none does, and its
    (sorts, skips) tally, on every torch; with the skip off it leaves the
    order to the sort and counts a sort."""
    n, m_cap = 128, 16
    live = torch.zeros(n, dtype=torch.bool)
    live[n_lo:n_lo + n_kept] = True
    dn, up = torch.zeros_like(live), torch.zeros_like(live)
    if crosser:
        (dn if crosser == "dn" else up)[n_lo] = True
    kept = live & ~dn & ~up
    want = sharded._sort_branch(sharded._categories(kept, dn, up, m_cap))
    with no_host_reads(torch.device("cpu")):
        order, tally = sharded._graphed_order(live, dn, up, m_cap, skip=True)
    assert torch.equal(order, want)
    assert tally.tolist() == ([1, 0] if crosser else [0, 1])
    if not crosser:
        assert torch.equal(order, sharded._skip_order(live, dn, up, n + m_cap))
    order, tally = sharded._graphed_order(live, dn, up, m_cap, skip=False)
    assert order is None and tally.tolist() == [1, 0]


def test_dist_simulator_grows_and_replays(monkeypatch):
    """`DistSimulator.run` on one slab rank through the whole machinery
    from a halo and a migration capacity too small: each chunk that
    overflowed runs again on the grown capacities, its graph captured once
    more a growth; 4 steps end equal to an ample run, and the timed step
    and `simulate()` replay too."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    cfg = ranks.dense_cfg()
    ample = DistSimulator(cfg, comm=SlabComm("cpu"), device="cpu")
    ample.setup()
    ample.run(4)
    tiny = DistConfig(1, cfg.padded_num_particles, 8, 8)
    sim = DistSimulator(cfg, comm=SlabComm("cpu"), dcfg=tiny, device="cpu")
    sim.setup()
    grows, grow = [], sim._grow
    monkeypatch.setattr(sim, "_grow", lambda aux: (grows.append(aux), grow(aux)))
    before = graphs.captures
    sim.run(4)
    assert grows and graphs.captures - before == len(grows) + 1
    np.testing.assert_allclose(sim.get_position(), ample.get_position(), rtol=0, atol=1e-6)
    times = Times()
    sim.simulate_and_time(times)
    ample.simulate_and_time(Times())
    sim.simulate(click=CLICK)
    ample.simulate(click=CLICK)
    assert times.iters == 1
    np.testing.assert_allclose(sim.get_position(), ample.get_position(), rtol=0, atol=1e-6)
