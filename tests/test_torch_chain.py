"""The port's chained device loop against tpusph on the CPU: the fields
step and its chain, the chunk API of the Simulator with its frames, the
device projections, chunked free mode, the capture-safe constants and the
launch accounting of graph replays. States come from `tpusph.core.init`;
positions are held at the step tests' bars (one step: rtol 1e-6 / atol
1e-6, density rtol 1e-5, force rtol 1e-4 / atol 1e-4; ten steps: the
bench bar, 1e-4), snapshots and frames of the port's own paths bit for
bit."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.core.state import FluidState as JState
from tpusph.engine.simulator import Simulator as JSimulator
from tpusph.engine.step import step_cell_list as jstep_cell_list
from tpusph.interact import impulse as jimp
from tpusph.neighbors import cell_list as jcl
from tpusph.neighbors import grid as jgrid
from tpusph.viz import project as jproject
from tpusph.viz import render as jrender
from tpusph_torch import cli
from tpusph_torch.core.config import PUSH_STRENGTH, f32
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.state import FIELDS, state_from_numpy
from tpusph_torch.engine import graphs
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import (
    fields_from_state,
    make_fields_chain,
    step_kernels,
    step_kernels_fields,
)
from tpusph_torch.interact import impulse as timp
from tpusph_torch.kernels import fused, graph_cond, qrank
from tpusph_torch.neighbors import grid as tgrid
from tpusph_torch.viz import project as tproject
from tpusph_torch.viz import render

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_step import CASES, IDS, _arrays  # noqa: E402

torch.set_num_threads(2)

ONE_STEP = dict(rtol=1e-6, atol=1e-6)


def _start(n, random_init=False, seed=0):
    st = jinit_state(jdefault(n, chunk_size=n), random_init=random_init, seed=seed)
    return {f: np.array(getattr(st, f)) for f in FIELDS}


def _pair(n, random_init=False, seed=0):
    """tpusph's Simulator (cell_list backend) and the port's, on the CPU,
    from the same initial state."""
    a = _start(n, random_init, seed)
    js = JSimulator(jdefault(n, chunk_size=n), backend="cell_list")
    js.setup(JState(**{f: jnp.asarray(v) for f, v in a.items()}))
    ts = Simulator(tdefault(n, chunk_size=n), device="cpu")
    ts.setup(state_from_numpy(a, "cpu"))
    return js, ts


# ------------------------------------------------- capture-safe constants


def _old_keys(position, valid, cfg):
    """The cell keys as computed before the constants were cached: a fresh
    float32 `h` tensor per call."""
    h = torch.tensor(f32(cfg.h), dtype=torch.float32)
    c = cfg.num_cells_per_dim
    raw = (position / h).to(torch.int32).clamp(0, c - 1)
    key = raw[:, 0] + c * raw[:, 1] + c * c * raw[:, 2]
    return torch.where(valid, key, cfg.num_cells).to(torch.int32)


def _old_kick(position, valid, cell, cfg):
    """The kick as computed before: host ints for the cell, fresh scalar
    tensors per call."""
    c = cfg.num_cells_per_dim
    h = torch.tensor(f32(cfg.h), dtype=torch.float32)
    mult = timp._slab_multiplicity(cfg)
    pc = (position / h).to(torch.int32).clamp(0, c - 1)
    dx, dy = pc[:, 0] - int(cell[0]), pc[:, 1] - int(cell[1])
    m = mult[pc[:, 2].long()].to(torch.float32)
    hit = (dx.abs() <= 2) & (dy.abs() <= 2) & valid
    push = torch.tensor(PUSH_STRENGTH, dtype=torch.float32)
    one, zero = torch.ones(()), torch.zeros(())
    kx = torch.where(dx != 0, push / torch.where(dx != 0, dx.float(), one), zero)
    ky = torch.where(dy != 0, push / torch.where(dy != 0, dy.float(), one), zero)
    kz = torch.where((dx == 0) & (dy == 0), -push, zero)
    return torch.stack([torch.where(hit, k * m, zero) for k in (kx, ky, kz)], dim=-1)


@pytest.mark.parametrize("random_init", [False, True], ids=["grid", "random"])
def test_capture_safe_constants_keep_keys_and_kicks(random_init):
    """N = 512, a click at pixel 400 (world x = 5.0, on a cell boundary):
    keys and kicks from the cached constants, with the cell as host ints
    and as a device int32 tensor, equal the per-call versions and tpusph."""
    n = 512
    a = _start(n, random_init, seed=3)
    # put particles on both sides of the clicked boundary at x = y = 5.0
    if random_init:
        a["position"][: n // 2, :2] = np.float32(5.0) + np.linspace(
            -0.3, 0.3, n // 2, dtype=np.float32)[:, None]
    else:  # the lattice's corner, x and y in [0.1, 0.46], moved to [4.9, 5.26]
        a["position"][:n, :2] += np.float32(4.8)
    cfg, jcfg = tdefault(n, chunk_size=n), jdefault(n, chunk_size=n)
    pos, valid = torch.from_numpy(a["position"]), torch.from_numpy(a["valid"])
    key = tgrid.compute_keys(pos, valid, cfg).key
    assert torch.equal(key, _old_keys(pos, valid, cfg))
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jgrid.compute_keys(jnp.asarray(a["position"]),
                                                   jnp.asarray(a["valid"]), jcfg).key))
    rows = [pos[:, i].contiguous() for i in range(3)]
    fkey, _ = tgrid.compute_keys_fields(*rows, valid, cfg)
    assert torch.equal(fkey, key)
    cell = timp.click_cell_from_px(400, 300, cfg)
    old = _old_kick(pos, valid, cell, cfg)
    assert (old != 0).any()
    assert torch.equal(timp.click_kick(pos, valid, cell, cfg), old)
    cell_t = torch.tensor(cell, dtype=torch.int32)
    assert torch.equal(timp.click_kick(pos, valid, cell_t, cfg), old)
    ref = jimp.click_kick(jnp.asarray(a["position"]), jnp.asarray(a["valid"]),
                          jnp.asarray(cell, jnp.int32), jcfg)
    np.testing.assert_array_equal(old.numpy(), np.asarray(ref))
    v = torch.randn(n, 3, generator=torch.Generator().manual_seed(0))
    on = timp.apply_kick(v, pos, valid, cell_t, torch.tensor(1, dtype=torch.int32), cfg)
    off = timp.apply_kick(v, pos, valid, cell_t, torch.tensor(0, dtype=torch.int32), cfg)
    assert torch.equal(on, v + old) and torch.equal(off, v)


# ---------------------------------------------------- launch accounting


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_replays_count_launches():
    """Each replay adds the per-replay launch counts taken at capture to the
    wrappers' counters; a wrapper the graph does not launch is left as it
    was."""
    stub = _StubGraph()
    g = graphs.CapturedGraph(stub, {qrank.rank_queries: 5, fused.density: 5, fused.force: 0})
    before = graphs.launch_counts()
    for _ in range(3):
        g.replay()
    after = graphs.launch_counts()
    assert stub.replays == 3
    assert after[qrank.rank_queries] - before[qrank.rank_queries] == 15
    assert after[fused.density] - before[fused.density] == 15
    assert after[fused.force] == before[fused.force]
    assert after[graph_cond.set_if] == before[graph_cond.set_if]
    # the step kernels, the force's packing and the device branch's set_if
    assert set(graphs.COUNTED) == {qrank.rank_queries, fused.density, fused.force_pack,
                                   fused.force, graph_cond.set_if}


# ----------------------------------------------------------- fields path


def _jax_steps(a, n, steps):
    cfg = jdefault(n, tile_cand_capacity=4096)
    step = jax.jit(lambda s: jstep_cell_list(s, cfg))
    st = JState(**{f: jnp.asarray(v) for f, v in a.items()})
    for _ in range(steps):
        st, aux = step(st)
        assert int(aux.window_overflow) == 0
    return st


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_one_fields_step_matches_cell_list_sorted(kind, n):
    """One step_kernels_fields step equals tpusph's step_cell_list taken
    into sorted order by tpusph's build_cell_list perm; `valid` exactly."""
    a = _arrays(kind, n)
    ref = _jax_steps(a, n, 1)
    perm = np.asarray(jcl.build_cell_list(
        jnp.asarray(a["position"]), jnp.asarray(a["valid"]), jdefault(n)).perm)
    (fs, rho, p, f_rows), aux = step_kernels_fields(
        fields_from_state(state_from_numpy(a, "cpu")), tdefault(n))
    assert aux.window_overflow == 0 and int(aux.oob_count) == 0
    v = a["valid"][perm]
    np.testing.assert_array_equal(fs.valid.numpy(), v)
    got_pos = torch.stack([fs.x, fs.y, fs.z], 1).numpy()
    got_vel = torch.stack([fs.vx, fs.vy, fs.vz], 1).numpy()
    np.testing.assert_allclose(got_pos, np.asarray(ref.position)[perm], **ONE_STEP)
    np.testing.assert_allclose(got_vel, np.asarray(ref.velocity)[perm], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rho.numpy()[v], np.asarray(ref.density)[perm][v], rtol=1e-5)
    np.testing.assert_allclose(torch.stack(f_rows, 1).numpy()[v],
                               np.asarray(ref.force)[perm][v], rtol=1e-4, atol=1e-4)


def _canon(pos, *fields):
    order = np.lexsort(pos.T)
    return (pos[order],) + tuple(f[order] for f in fields)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_fields_chain_matches_cell_list(kind, n):
    """10 chained fields steps (make_fields_chain, an eager loop on the
    CPU) at the bench bar, multiset-compared; and equal to 10 single fields
    steps bit for bit."""
    a = _arrays(kind, n)
    ref = _jax_steps(a, n, 10)
    fs0 = fields_from_state(state_from_numpy(a, "cpu"))
    out, ovf = make_fields_chain(tdefault(n), 10, "cpu")(fs0)
    assert ovf.dtype == torch.int32 and int(ovf) == 0
    fs = fs0
    for _ in range(10):
        (fs, rho, _, _), _ = step_kernels_fields(fs, tdefault(n))
    for x, y in zip(out, fs):
        assert torch.equal(x, y)
    v, rv = fs.valid.numpy(), a["valid"]
    assert v.sum() == rv.sum()
    pa, ra = _canon(torch.stack([fs.x, fs.y, fs.z], 1).numpy()[v], rho.numpy()[v])
    pb, rb = _canon(np.asarray(ref.position)[rv], np.asarray(ref.density)[rv])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ra, rb, rtol=1e-4)


def test_fields_chain_refuses_another_device():
    fs = fields_from_state(state_from_numpy(_start(256), "cpu"))
    with pytest.raises(ValueError):
        make_fields_chain(tdefault(256), 2, "meta")(fs)


# --------------------------------------------------------- chunk API


def test_chunked_positions_match_sequential():
    """Port of tests/test_simulator.py::test_chunked_positions_match_sequential:
    the chunk's per-step snapshots and its final velocity equal five
    sequential simulate() calls bit for bit, with a click at step 2."""
    n, clicks = 256, {2: (400, 300)}
    a = _start(n, True, 9)
    sim = Simulator(tdefault(n, chunk_size=n), device="cpu")
    sim.setup(state_from_numpy(a, "cpu"))
    pos = sim.simulate_chunk(5, clicks=clicks)
    assert pos.shape == (5, n, 3)
    ref = Simulator(tdefault(n, chunk_size=n), device="cpu")
    ref.setup(state_from_numpy(a, "cpu"))
    for k in range(5):
        ref.simulate(click=clicks.get(k))
        np.testing.assert_array_equal(pos[k], ref.get_position(), err_msg=str(k))
    assert torch.equal(sim.state.velocity, ref.state.velocity)
    assert sim.state.velocity.abs().max() > 1.0  # the click reached the fluid


def test_simulate_chunk_matches_tpusph():
    """N = 256, a click at step 2: the port's chunk against tpusph's
    `simulate_chunk` at the step tests' bars."""
    js, ts = _pair(256, True, 9)
    clicks = {2: (400, 300)}
    ref = js.simulate_chunk(5, clicks=clicks)
    got = ts.simulate_chunk(5, clicks=clicks)
    assert got.shape == ref.shape == (5, 256, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.state.velocity.numpy(), np.asarray(js.state.velocity),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pack", [True, "bitmap"], ids=["packed", "bitmap"])
def test_chunk_frames_match_sequential(pack):
    """Port of tests/test_simulator.py::test_chunked_bitmap_stream_matches_sequential,
    for both device frame streams: a chunk's frames equal the projections of
    the sequential positions bit for bit, and the drawn frames equal
    render_frame of those positions."""
    n = 512
    sim, ref = (Simulator(tdefault(n, chunk_size=n), device="cpu") for _ in range(2))
    sim.setup()
    ref.setup()
    frames, ovf = sim.dispatch_chunk(3, pack_pixels=pack).fetch.wait()
    assert ovf == 0
    if pack == "bitmap":
        assert frames.shape == (3, 600, 100) and frames.dtype == np.uint8
    else:
        assert frames.shape == (3, n) and frames.dtype == np.int32
    for k in range(3):
        ref.simulate()
        pos = ref.get_position()
        proj = tproject.project_bitmap if pack == "bitmap" else tproject.project_pixels_packed
        np.testing.assert_array_equal(frames[k], proj(torch.from_numpy(pos)).numpy())
        draw = render.render_frame_bitmap if pack == "bitmap" else render.render_frame_packed
        np.testing.assert_array_equal(draw(frames[k]), render.render_frame(pos))


def test_rewind_restores_the_pre_chunk_state():
    _, ts = _pair(256)
    pre = ts.state
    h = ts.dispatch_chunk(2)
    assert ts.state is not pre
    cap = ts.cfg.tile_cand_capacity
    ts.rewind_chunk(h)
    assert ts.state is pre and ts.cfg.tile_cand_capacity == 2 * cap
    ts.rewind_chunk(h, grow=False)
    assert ts.cfg.tile_cand_capacity == 2 * cap


# ----------------------------------------------------------- projections


def _points():
    rng = np.random.default_rng(3)
    return rng.uniform(-2.0, 12.0, size=(4096, 3)).astype(np.float32)


def test_project_pixels_packed_equals_tpusph():
    pos = _points()
    got = tproject.project_pixels_packed(torch.from_numpy(pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jproject.project_pixels_packed(jnp.asarray(pos))))
    assert tproject.PACK_INSIDE == jproject.PACK_INSIDE


def test_project_bitmap_equals_tpusph():
    pos = _points()
    got = tproject.project_bitmap(torch.from_numpy(pos))
    assert got.dtype == torch.uint8 and got.shape == (600, 100)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jproject.project_bitmap(jnp.asarray(pos))))


def test_device_projection_matches_host():
    """Port of tests/test_simulator.py::test_device_projection_matches_host."""
    pos = _points()
    packed = tproject.project_pixels_packed(torch.from_numpy(pos)).numpy()
    px, z = render.project(pos)
    inside = (
        (px[:, 0] >= 1) & (px[:, 0] < render.WIDTH - 1)
        & (px[:, 1] >= 1) & (px[:, 1] < render.HEIGHT - 1) & (z > render.NEAR)
    )
    np.testing.assert_array_equal((packed & tproject.PACK_INSIDE) != 0, inside)
    np.testing.assert_array_equal(packed[inside] & 0x3FF, px[inside, 0].astype(np.int32))
    np.testing.assert_array_equal((packed[inside] >> 10) & 0x3FF, px[inside, 1].astype(np.int32))


def test_bitmap_frame_matches_packed():
    """Port of tests/test_simulator.py::test_bitmap_frame_matches_packed, and
    both frames equal tpusph's drawing of the same stream."""
    pos = torch.from_numpy(_points())
    packed = tproject.project_pixels_packed(pos).numpy()
    bits = tproject.project_bitmap(pos).numpy()
    assert bits.nbytes == 600 * 100
    img = render.render_frame_bitmap(bits)
    np.testing.assert_array_equal(img, render.render_frame_packed(packed))
    np.testing.assert_array_equal(img, jrender.render_frame_bitmap(bits))
    np.testing.assert_array_equal(img, render.render_frame(pos.numpy()))


# ----------------------------------------------------- chunked free mode


def _sequential_frames(n, frames, clicks, seed):
    ref = Simulator(tdefault(n, chunk_size=n), random_init=True, seed=seed, device="cpu")
    ref.setup()
    out = []
    for k in range(frames):
        ref.simulate(click=clicks.get(k))
        out.append(render.render_frame(ref.get_position()))
    return out


@pytest.mark.parametrize("pack", ["0", "1", "bitmap"])
def test_chunked_free_mode_frames_match_sequential(tmp_path, monkeypatch, pack):
    """Port of tests/test_simulator.py::test_chunked_free_mode_frames_match_sequential:
    TPUSPH_VIZ_CHUNK=3 over 7 frames (an uneven tail chunk), two clicks, for
    each frame stream: the PNGs decode to the sequential loop's frames."""
    from test_torch_simulator import _png_pixels

    n, clicks = 128, {1: (400, 300), 4: (350, 250)}
    monkeypatch.setenv("TPUSPH_VIZ_CHUNK", "3")
    monkeypatch.setenv("TPUSPH_VIZ_PACK", pack)
    sim = Simulator(tdefault(n, chunk_size=n), random_init=True, seed=4, device="cpu")
    sim.setup()
    out = tmp_path / "frames"
    render.run_free_mode(sim, frames=7, out_dir=str(out), clicks=clicks)
    assert sorted(os.listdir(out)) == [f"frame_{k:05d}.png" for k in range(7)]
    for k, want in enumerate(_sequential_frames(n, 7, clicks, 4)):
        np.testing.assert_array_equal(_png_pixels(str(out / f"frame_{k:05d}.png")), want)


def test_chunked_free_mode_replays_an_overflow(tmp_path, monkeypatch):
    """The cell_list backend from a capacity that overflows: the chunked loop
    rewinds, grows and replays, and writes the frames of an ample-capacity
    run."""
    from test_torch_simulator import _png_pixels

    n = 512
    sim = Simulator(tdefault(n, chunk_size=n, tile_cand_capacity=64), backend="cell_list",
                    device="cpu")
    sim.setup()
    out = tmp_path / "frames"
    render.run_free_mode(sim, frames=4, out_dir=str(out), chunk=2)
    assert sim.cfg.tile_cand_capacity > 64
    ref = Simulator(tdefault(n, chunk_size=n), backend="cell_list", device="cpu")
    ref.setup()
    for k in range(4):
        ref.simulate()
        got = _png_pixels(str(out / f"frame_{k:05d}.png"))
        np.testing.assert_array_equal(got, render.render_frame(ref.get_position()))


def test_frame_pack_defaults(monkeypatch):
    monkeypatch.delenv("TPUSPH_VIZ_PACK", raising=False)
    assert render.frame_pack(65536) == "bitmap" and render.frame_pack(65535) is True
    monkeypatch.setenv("TPUSPH_VIZ_PACK", "0")
    assert render.frame_pack(262144) is False


def test_cli_viz_chunk(tmp_path, capsys):
    out = tmp_path / "frames"
    rc = cli.main(["-n", "256", "-m", "free", "--frames", "5", "--viz-chunk", "3",
                   "--click", "1:400,300", "--out", str(out), "--device", "cpu"])
    assert rc == 0, capsys.readouterr().err
    assert sorted(os.listdir(out)) == [f"frame_{k:05d}.png" for k in range(5)]


def test_cli_backend_names(capsys):
    for name in ("auto", "pallas", "kernels"):
        assert cli.main(["-n", "256", "-m", "time", "--steps", "1", "--warmup", "0",
                         "--backend", name, "--device", "cpu"]) == 0
    assert cli.main(["--backend", "bogus"]) == 1
    capsys.readouterr()


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_fields_step_matches_scattered_step(kind, n):
    """One fields step and one step_kernels step give the same particles
    (a multiset compare), bit for bit: the same sums on the same sorted
    rows."""
    st = state_from_numpy(_arrays(kind, n), "cpu")
    (fs, rho, _, _), _ = step_kernels_fields(fields_from_state(st), tdefault(n))
    s_scat, _ = step_kernels(st, tdefault(n))
    pa, ra = _canon(torch.stack([fs.x, fs.y, fs.z], 1).numpy(), rho.numpy())
    pb, rb = _canon(s_scat.position.numpy(), s_scat.density.numpy())
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ra, rb)
