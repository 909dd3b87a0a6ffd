"""The port's `cell_list` backend against tpusph's on the CPU: the starts
histogram and the sorted-fields build bit for bit (integers and moved
floats), the tile-pass step at `test_one_step_matches_cell_list`'s bars
with the same overflow count, and the grow-and-replay of the Simulator
(tests/test_simulator.py's capacity tests, which run fast here, so they
are not marked slow), which the kernels backend never enters."""

import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.state import FluidState as JState
from tpusph.engine.step import step_cell_list as jstep_cell_list
from tpusph.neighbors import cell_list as jcl
from tpusph.utils.chunking import pick_chunk as jpick_chunk
from tpusph_torch import cli
from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.state import state_from_numpy, state_to_numpy
from tpusph_torch.engine import simulator as sim_mod
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import step_cell_list
from tpusph_torch.kernels import fused
from tpusph_torch.neighbors import cell_list as tcl
from tpusph_torch.neighbors.cell_list import build_cell_list
from tpusph_torch.neighbors.grid import compute_keys
from tpusph_torch.utils.chunking import pick_chunk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_step import CASES, IDS, _arrays  # noqa: E402

torch.set_num_threads(2)


def _keys(a, n):
    """(key, key_sorted) numpy int32 of the state `a`, from the port."""
    k = compute_keys(torch.from_numpy(a["position"]), torch.from_numpy(a["valid"]), tdefault(n))
    return k.key.numpy(), torch.sort(k.key, stable=True)[0].numpy()


@pytest.mark.parametrize("n,target", [(512, 256), (1000, 256), (4096, 768), (97, 256), (97, 10)])
def test_pick_chunk_equal(n, target):
    assert pick_chunk(n, target) == jpick_chunk(n, target)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_starts_table_equal(kind, n):
    a = _arrays(kind, n)
    key, key_sorted = _keys(a, n)
    want = np.asarray(jcl.starts_table(jnp.asarray(key), jdefault(n)))
    got = tcl.starts_table(torch.from_numpy(key), tdefault(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    starts, ovf = tcl.starts_from_sorted(torch.from_numpy(key_sorted), tdefault(n))
    np.testing.assert_array_equal(starts.numpy(), want)
    assert ovf == 0


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_build_sorted_fields_1d_equal(kind, n):
    a = _arrays(kind, n)
    rows = [np.ascontiguousarray(a[f][:, i]) for f in ("position", "velocity") for i in range(3)]
    ref = jcl.build_sorted_fields_1d(*map(jnp.asarray, rows), jnp.asarray(a["valid"]), jdefault(n))
    got = tcl.build_sorted_fields_1d(
        *map(torch.from_numpy, rows), torch.from_numpy(a["valid"]), tdefault(n))
    for f in ("key_sorted", "x", "y", "z", "vx", "vy", "vz", "starts", "valid_sorted"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert int(got.oob_count) == int(ref.oob_count)


def _one_step(a, n, **kw):
    """(tpusph's state, overflow), (the port's state, overflow) after one
    step_cell_list on both."""
    jst, jaux = jax.jit(lambda s: jstep_cell_list(s, jdefault(n, **kw)))(
        JState(**{f: jnp.asarray(v) for f, v in a.items()}))
    tst, taux = step_cell_list(state_from_numpy(a, "cpu"), tdefault(n, **kw))
    ref = {f: np.asarray(getattr(jst, f)) for f in a}
    return (ref, int(jaux.window_overflow)), (state_to_numpy(tst), taux.window_overflow)


def force_floor(a, n) -> float:
    """The float32 floor of the blob's force sums: ~2,600 cancelling
    candidate terms per target, summed in another order than XLA's, differ
    by about sqrt(K)·eps·max|f| (the bar of tests/test_torch_cuda.py). On
    the blob both packages are ~2.5e-4 from a float64 evaluation of the
    same passes, so 1e-4 is below the reference's own rounding there."""
    cl = build_cell_list(torch.from_numpy(a["position"]), torch.from_numpy(a["valid"]), tdefault(n))
    _, count = fused.windows(cl.key_sorted, cl.starts, tdefault(n))
    k = float(count.sum(dim=1).max())
    return k**0.5 * float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_step_cell_list_matches_tpusph(kind, n):
    """At test_one_step_matches_cell_list's bars, but for the blob's forces
    (see force_floor); the blob needs a capacity that does not overflow
    (tpusph's own tests use 4096)."""
    a = _arrays(kind, n)
    (ref, rovf), (got, ovf) = _one_step(a, n, tile_cand_capacity=4096)
    assert rovf == 0 and ovf.dtype == torch.int32 and int(ovf) == 0
    v = a["valid"]
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["density"][v], ref["density"][v], rtol=1e-5)
    f_atol = 1e-4
    if kind == "blob":
        f_atol = force_floor(a, n) * float(np.abs(ref["force"]).max())
    np.testing.assert_allclose(got["force"][v], ref["force"][v], rtol=1e-4, atol=f_atol)
    np.testing.assert_allclose(got["position"], ref["position"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_window_overflow_equals_tpusph(kind, n):
    a = _arrays(kind, n)
    (_, rovf), (_, ovf) = _one_step(a, n, tile_cand_capacity=64)
    assert rovf > 0 and int(ovf) == rovf


def _tiny(**kw):
    return Simulator(tdefault(512, chunk_size=512, **kw), backend="cell_list", device="cpu")


def test_capacity_growth_on_overflow():
    """Port of tests/test_simulator.py::test_capacity_growth_on_overflow."""
    sim = _tiny(tile_cand_capacity=64)
    sim.setup()
    sim.simulate()
    assert sim.cfg.tile_cand_capacity > 64
    ref = _tiny()
    ref.setup()
    ref.simulate()
    np.testing.assert_allclose(sim.get_position(), ref.get_position(), atol=1e-6)


def test_timed_retry_excludes_failed_attempt(monkeypatch):
    """Port of tests/test_simulator.py::test_timed_retry_excludes_failed_attempt:
    perf_counter advances 1.0 a call, so without the rollback the
    overflowing attempt would leave 2.0 in each phase."""
    sim = _tiny(tile_cand_capacity=64)
    sim.setup()
    counter = itertools.count()
    monkeypatch.setattr(sim_mod.time, "perf_counter", lambda: float(next(counter)))
    times = Times()
    sim.simulate_and_time(times)
    assert sim.cfg.tile_cand_capacity > 64
    assert times.iters == 1
    assert times.build_grid == times.sph_update == times.memcpy == 1.0


def test_chunked_overflow_rewind():
    """Port of tests/test_simulator.py::test_chunked_overflow_rewind."""
    sim = _tiny(tile_cand_capacity=64)
    sim.setup()
    pos = sim.simulate_chunk(3)
    assert sim.cfg.tile_cand_capacity > 64
    ref = _tiny()
    ref.setup()
    for k in range(3):
        ref.simulate()
        np.testing.assert_allclose(pos[k], ref.get_position(), atol=1e-6, err_msg=str(k))


def test_cell_list_backend_matches_kernels():
    """10 steps of the two backends at the 1e-4 bar (the plain kernels here)."""
    a, b = _tiny(), Simulator(tdefault(512, chunk_size=512), device="cpu")
    for s in (a, b):
        s.setup()
        for _ in range(10):
            s.simulate()
    np.testing.assert_allclose(a.get_position(), b.get_position(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.state.density, b.state.density, rtol=1e-4)


@pytest.mark.parametrize("timed", [False, True], ids=["simulate", "simulate_and_time"])
def test_kernels_backend_never_grows(monkeypatch, timed):
    """The kernels have no capacity: their overflow is the int 0, so
    neither step loop reads an overflow from the device nor grows."""
    sim = Simulator(tdefault(512, chunk_size=512), device="cpu")
    sim.setup()

    def refuse():
        raise AssertionError("the kernels backend grew its capacity")

    monkeypatch.setattr(sim, "_grow_capacity", refuse)
    for _ in range(3):
        sim.simulate_and_time(Times()) if timed else sim.simulate()
        assert sim.last_aux.window_overflow == 0
        assert not isinstance(sim.last_aux.window_overflow, torch.Tensor)


def test_cli_cell_list_time_mode(capsys):
    rc = cli.main(["-n", "512", "-m", "time", "--steps", "2", "--backend", "cell_list",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Grid construction" in out and "Per frame" in out
