"""The port's step (tpusph_torch.engine.step, CPU tensors, so the kernels'
plain versions) against the JAX package's `step_cell_list`, the NumPy
oracle and the grid golden trajectory; the Simulator and the CLI on the
CPU; and the import boundary (the port never imports jax)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.core.state import FluidState as JState
from tpusph.engine.step import step_allpairs as jstep_allpairs
from tpusph.engine.step import step_cell_list
from tpusph_torch import cli
from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.init import init_state as tinit_state
from tpusph_torch.core.state import FIELDS, state_from_numpy, state_to_numpy
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import make_step, step_allpairs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_numpy import oracle_step  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _arrays(kind, n):
    """Initial state as numpy arrays, from the JAX package's init (grid,
    random) or a compressed blob with random velocities (pressure live)."""
    cfg = jdefault(n)
    st = jinit_state(cfg, random_init=(kind == "random"), seed=n)
    a = {f: np.array(getattr(st, f)) for f in FIELDS}
    if kind == "blob":
        rng = np.random.default_rng(n)
        a["position"][:n] = rng.uniform(4.0, 4.35, (n, 3))
        a["velocity"][:n] = rng.normal(0, 0.5, (n, 3))
    return a


CASES = [("grid", 512), ("random", 1024), ("blob", 2000)]
IDS = [f"{k}{n}" for k, n in CASES]


def _jax_steps(a, n, steps):
    # a capacity wide enough for the blob; capacities do not change physics
    cfg = jdefault(n, tile_cand_capacity=4096)
    step = jax.jit(lambda s: step_cell_list(s, cfg))
    st = JState(**{f: jnp.asarray(v) for f, v in a.items()})
    for _ in range(steps):
        st, aux = step(st)
        assert int(aux.window_overflow) == 0
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def _port_steps(a, n, steps, backend="kernels"):
    step = make_step(tdefault(n), backend, "cpu")
    st = state_from_numpy(a, "cpu")
    for _ in range(steps):
        st, aux = step(st)
        assert aux.window_overflow == 0
    return state_to_numpy(st)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_one_step_matches_cell_list(kind, n):
    a = _arrays(kind, n)
    ref, got = _jax_steps(a, n, 1), _port_steps(a, n, 1)
    v = a["valid"]
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["density"][v], ref["density"][v], rtol=1e-5)
    np.testing.assert_allclose(got["force"][v], ref["force"][v], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["position"], ref["position"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_ten_steps_match_cell_list(kind, n):
    """The bench.py bar: 1e-4 relative density, 1e-4 positions."""
    a = _arrays(kind, n)
    ref, got = _jax_steps(a, n, 10), _port_steps(a, n, 10)
    v = a["valid"]
    np.testing.assert_allclose(got["density"][v], ref["density"][v], rtol=1e-4)
    np.testing.assert_allclose(got["position"][v], ref["position"][v], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_one_step_matches_numpy_oracle(kind, n):
    a = _arrays(kind, n)
    got = _port_steps(a, n, 1)
    v = a["valid"]
    ref = oracle_step(a["position"][v], a["velocity"][v], tdefault(n))
    np.testing.assert_allclose(got["density"][v], ref["density"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["position"][v], ref["position"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,n", CASES[:2], ids=IDS[:2])
def test_allpairs_matches_jax_and_kernels(kind, n):
    a = _arrays(kind, n)
    got = _port_steps(a, n, 2, "allpairs")
    st = JState(**{f: jnp.asarray(x) for f, x in a.items()})
    cfg = jdefault(n)
    for _ in range(2):
        st, _ = jstep_allpairs(st, cfg)
    v = a["valid"]
    np.testing.assert_allclose(got["density"][v], np.asarray(st.density)[v], rtol=1e-5)
    np.testing.assert_allclose(got["position"], np.asarray(st.position), atol=1e-6, rtol=1e-6)
    kern = _port_steps(a, n, 2)
    np.testing.assert_allclose(got["density"][v], kern["density"][v], rtol=1e-5)


def _golden_start(init):
    """The golden's initial state: the port's grid init, or tpusph's random
    init at seed 42 carried over (the two packages draw other numbers from
    one seed)."""
    if init == "grid":
        return tinit_state(tdefault(256, chunk_size=256), device="cpu")
    st = jinit_state(jdefault(256, chunk_size=256), random_init=True, seed=42)
    return state_from_numpy({f: np.array(getattr(st, f)) for f in FIELDS}, "cpu")


def _check_golden(name, init, backend):
    """15 steps against tests/golden/<name> at test_golden.py's bar."""
    step = make_step(tdefault(256, chunk_size=256), backend, "cpu")
    st = _golden_start(init)
    for _ in range(15):
        st, _ = step(st)
    v = st.valid
    with np.load(os.path.join(GOLDEN, name)) as ref:
        for k in ("position", "velocity", "density"):
            np.testing.assert_allclose(
                getattr(st, k)[v].numpy(), ref[k], rtol=1e-5, atol=1e-6,
                err_msg=f"golden mismatch in {k} ({name}, {backend})")


def test_golden_grid_trajectory():
    """tests/golden/traj_grid256_15.npz at test_golden.py's bar."""
    _check_golden("traj_grid256_15.npz", "grid", "kernels")


@pytest.mark.parametrize("backend", ["kernels", "cell_list", "allpairs"])
@pytest.mark.parametrize("name,init", [
    ("traj_grid256_15.npz", "grid"),
    ("traj_rand256_15.npz", "random"),
    ("traj_rand256_15_pallas.npz", "random"),
], ids=["grid", "rand", "rand_pallas"])
def test_golden_trajectories(name, init, backend):
    """All three goldens of tests/golden (tpusph's cell_list on grid and
    random init, its Pallas kernels on random init) hold for every backend
    of the port at rtol 1e-5 / atol 1e-6."""
    _check_golden(name, init, backend)


def test_simulator_simulate_and_time_cpu():
    sim = Simulator(tdefault(1000), device="cpu")
    sim.setup()
    times = Times()
    for _ in range(3):
        sim.simulate_and_time(times)
    assert times.iters == 3
    assert times.build_grid > 0 and times.sph_update > 0 and times.memcpy >= 0
    pos = sim.get_position()
    assert pos.shape == (1000, 3) and np.isfinite(pos).all()
    assert int(sim.last_aux.oob_count) == 0 and sim.last_aux.window_overflow == 0
    sim.simulate()
    assert sim.get_position().shape == (1000, 3)
    assert not np.array_equal(sim.get_position(), pos)


def test_cli_time_mode_prints_times(capsys):
    rc = cli.main(["-n", "512", "-i", "grid", "-m", "time", "--steps", "2",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Operation" in out and "Per frame" in out and "Total" in out
    for row in ("Grid construction", "SPH update", "Data transfer"):
        assert row in out


@pytest.mark.parametrize("args", [["--mesh", "z", "--backend", "allpairs"]], ids=["mesh"])
def test_cli_refuses_unported_modes(args, capsys):
    """The sharded engines run the kernels or the tile passes; the O(N^2)
    oracle under --mesh is refused with the usage text."""
    assert cli.main(["-n", "256", "--device", "cpu", *args]) != 0
    captured = capsys.readouterr()
    assert "not allpairs" in captured.err and "Program Options" in captured.out


@pytest.mark.parametrize("args,rc", [
    (["--stencil", "slab3"], 1),
    (["--pallas-col-capacity", "16384"], 1),
    (["--pallas-sub-blocks", "80"], 1),
    (["--window-capacity", "256"], 1),
    (["--gif", "out.gif"], 0),
    (["--mesh", "2x2x2"], 1),
    (["-m", "free"], 0),
], ids=["stencil", "col_capacity", "sub_blocks", "window_capacity", "gif", "mesh", "window"])
def test_cli_refuses_tpusph_flags_it_does_not_take(args, rc, capsys, monkeypatch):
    """The flags of tpusph/cli.py that the port's docstring lists as not
    taken: argparse rejects the Pallas sizing flags (usage text, exit code
    1), nothing simulated. --mesh is taken, and a grid of 8 bricks on a
    group of one rank is refused the same way. The two that it has come to
    take return 0 as in tpusph: --gif without --frames writes nothing, and
    the interactive window without a display prints the hint."""
    monkeypatch.delenv("DISPLAY", raising=False)
    assert cli.main(["-n", "256", "--device", "cpu", "--steps", "1", *args]) == rc
    captured = capsys.readouterr()
    if rc == 1:
        assert "Program Options" in captured.out
    elif args == ["-m", "free"]:
        assert "No interactive display" in captured.out and "--frames" in captured.out
    else:
        assert not os.path.exists("out.gif")
    for flag in args[:1]:
        if flag.startswith("--"):
            assert flag in cli.__doc__


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    """`--profile DIR` (tpusph/cli.py:95-101) wraps the timed steps in
    torch.profiler and leaves a Chrome trace in DIR."""
    import json

    out = tmp_path / "prof"
    rc = cli.main(["-n", "256", "-m", "time", "--steps", "3", "--device", "cpu",
                   "--profile", str(out)])
    assert rc == 0, capsys.readouterr().err
    files = os.listdir(out)
    assert files == ["trace.json"]
    with open(out / "trace.json") as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
    assert "Grid construction" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_cli_takes_tpusph_backend_names(backend, capsys):
    rc = cli.main(["-n", "256", "-m", "time", "--steps", "1", "--warmup", "0",
                   "--device", "cpu", "--backend", backend])
    assert rc == 0, capsys.readouterr().err


def test_cli_usage(capsys):
    assert cli.main(["-?"]) == 1
    assert "Number of particles to simulate" in capsys.readouterr().out
    assert cli.main(["-i", "bogus"]) == 1


def test_port_never_imports_jax():
    code = (
        "import sys, tpusph_torch, tpusph_torch.cli, tpusph_torch.core.io, "
        "tpusph_torch.utils.cuda_build, tpusph_torch.kernels.probes, "
        "tpusph_torch.scripts.vpu_microbench, tpusph_torch.scripts.loop_probe, "
        "tpusph_torch.scripts.loop_probe_sweep, "
        "tpusph_torch.interact.impulse, tpusph_torch.viz.render, "
        "tpusph_torch.viz.project, tpusph_torch.engine.graphs, tpusph_torch.engine.step, "
        "tpusph_torch.engine.simulator, tpusph_torch.neighbors.cell_list, "
        "tpusph_torch.utils.chunking, tpusph_torch.utils.native, "
        "tpusph_torch.bench.diagnostics, tpusph_torch.dist.comm, "
        "tpusph_torch.dist.sharded, tpusph_torch.dist.mesh3d, tpusph_torch.dist.multislice, "
        "tpusph_torch.dist.simulator, tpusph_torch.graft_entry, "
        "tpusph_torch.scripts.build_bench, tpusph_torch.scripts.dist_scale_check, "
        "tpusph_torch.scripts.fields_profile, tpusph_torch.scripts.freemode_bench, "
        "tpusph_torch.scripts.dist_profile, tpusph_torch.scripts.slab_census, "
        "tpusph_torch.scripts.scaling_model, bench_torch, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpusph')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
