"""The port's Simulator (double-buffered timed steps, the position fetch,
stepping with a click), the click impulse, the frame renderer and the
CLI's free mode and checkpoints, against tpusph on the CPU. Every state
starts from `tpusph.core.init` at N = 512, carried across with
`state_from_numpy`. Positions are held at the golden bar (rtol 1e-5,
atol 1e-6); the impulse and the frames are compared exactly."""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph import cli as jcli
from tpusph.bench.times import Times as JTimes
from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.core.state import FluidState as JState
from tpusph.engine.simulator import Simulator as JSimulator
from tpusph.interact import impulse as jimp
from tpusph.viz.render import _render_frame_numpy
from tpusph_torch import cli
from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.state import FIELDS, state_from_numpy
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import make_step
from tpusph_torch.interact import impulse as timp
from tpusph_torch.viz import render

torch.set_num_threads(2)

N = 512
GOLDEN = dict(rtol=1e-5, atol=1e-6)
# a pixel whose click cell holds particles of the N = 512 grid init
# (x = 0.1, y in [0.1, 0.46]): x cell 0, flipped y cell 3
CLICK_ON_FLUID = (206, 442)


def _start() -> dict:
    st = jinit_state(jdefault(N))
    return {f: np.array(getattr(st, f)) for f in FIELDS}


def _pair():
    """tpusph's Simulator (cell_list backend) and the port's, on the CPU,
    both set up with the same initial state."""
    a = _start()
    js = JSimulator(jdefault(N), backend="cell_list")
    js.setup(JState(**{f: jnp.asarray(v) for f, v in a.items()}))
    ts = Simulator(tdefault(N), device="cpu")
    ts.setup(state_from_numpy(a, "cpu"))
    return js, ts


def test_timed_steps_match_tpusph():
    js, ts = _pair()
    jt, tt = JTimes(), Times()
    for _ in range(3):
        js.simulate_and_time(jt)
        ts.simulate_and_time(tt)
        np.testing.assert_allclose(ts.get_position(), js.get_position(), **GOLDEN)
    assert tt.iters == 3 and tt.memcpy >= 0


def test_position_fetch_copies_the_current_state():
    _, ts = _pair()
    ts.simulate()
    fetch = ts.get_position_async()
    got = fetch.wait()
    np.testing.assert_array_equal(got, ts.state.position[:N].numpy())
    assert fetch.matches(ts.state.position)
    assert ts.get_position() is got  # joins the fetch of the current state
    kept = got.copy()
    ts.simulate()
    assert not fetch.matches(ts.state.position)
    assert not np.array_equal(ts.get_position(), got)
    np.testing.assert_array_equal(got, kept)  # a handed-out array is never reused


def test_timed_fetch_covers_the_new_state():
    """After a timed step the fetch in flight is the new state's, and the
    array of the step before stays as it was."""
    _, ts = _pair()
    times = Times()
    ts.simulate_and_time(times)
    first = ts.get_position()
    kept = first.copy()
    ts.simulate_and_time(times)
    np.testing.assert_array_equal(ts.get_position(), ts.state.position[:N].numpy())
    np.testing.assert_array_equal(first, kept)


def _click_lattice():
    """Particles every 0.05 around the box centre, on both sides of the
    cell boundaries at multiples of 0.1; the last 10 slots invalid."""
    g = np.arange(4.6, 5.65, 0.05, dtype=np.float64)
    xs, ys, zs = np.meshgrid(g, g, np.array([0.05, 2.0, 5.0, 5.05, 9.95]), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1).astype(np.float32)
    valid = np.ones(len(pos), bool)
    valid[-10:] = False
    return pos, valid


@pytest.mark.parametrize(
    "px,py", [(400, 300), (401, 299), (404, 296), (199, 300)],
    ids=["centre-on-boundary", "next-pixel", "offset-cell", "outside-box"])
def test_click_kick_matches_tpusph(px, py):
    assert timp.click_in_box(px, py) == jimp.click_in_box(px, py)
    jcfg, tcfg = jdefault(N), tdefault(N)
    cell = timp.click_cell_from_px(px, py, tcfg)
    assert cell == jimp.click_cell_from_px(px, py, jcfg)
    pos, valid = _click_lattice()
    ref = np.asarray(jimp.click_kick(
        jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(cell, jnp.int32), jcfg))
    got = timp.click_kick(torch.from_numpy(pos), torch.from_numpy(valid), cell, tcfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != 0).any() == timp.click_in_box(px, py)


@pytest.mark.parametrize("px,py", [(400, 300), CLICK_ON_FLUID], ids=["centre", "on-fluid"])
def test_apply_click_impulse_matches_tpusph(px, py):
    """`apply_click_impulse` (what tpusph's dist tests use as the
    single-card click) on the grid init state, velocities made nonzero,
    with the positions of one step earlier: the velocities equal tpusph's
    bit for bit, kicked where the click lands on fluid."""
    a = _start()
    a["velocity"] = np.random.default_rng(5).normal(size=a["velocity"].shape).astype(np.float32)
    pre = a["position"] + np.float32(0.05)
    want = jimp.apply_click_impulse(
        JState(**{f: jnp.asarray(v) for f, v in a.items()}), jnp.asarray(pre), (px, py),
        jdefault(N))
    got = timp.apply_click_impulse(state_from_numpy(a, "cpu"), torch.from_numpy(pre),
                                   np.array([px, py]), tdefault(N))
    np.testing.assert_array_equal(got.velocity.numpy(), np.asarray(want.velocity))
    kicked = (got.velocity.numpy() != a["velocity"]).any()
    assert kicked == ((px, py) == CLICK_ON_FLUID)  # the centre misses N = 512's corner
    np.testing.assert_array_equal(got.position.numpy(), a["position"])


def test_slab_multiplicity_matches_tpusph():
    np.testing.assert_array_equal(
        timp._slab_multiplicity(tdefault(N)).numpy(),
        np.asarray(jimp._slab_multiplicity(jdefault(N))))


def test_steps_with_a_click_match_tpusph():
    js, ts = _pair()
    before = ts.state.velocity.clone()
    ts.move_particles((199, 300))  # outside the box: nothing moves
    assert torch.equal(ts.state.velocity, before)
    for k in range(3):
        click = CLICK_ON_FLUID if k == 0 else None
        js.simulate(click=click)
        ts.simulate(click=click)
        np.testing.assert_allclose(ts.get_position(), js.get_position(), **GOLDEN)
        np.testing.assert_allclose(
            ts.state.velocity.numpy(), np.asarray(js.state.velocity), rtol=1e-5, atol=1e-5)
    # the click reached the fluid: the kick from the first step's cells
    _, fresh = _pair()
    cell = timp.click_cell_from_px(*CLICK_ON_FLUID, tdefault(N))
    kick = timp.click_kick(fresh.state.position, fresh.state.valid, cell, tdefault(N))
    assert kick.abs().max() > 0


def _png_pixels(path):
    """Decode an 8-bit RGB PNG whose rows all use filter 0 (save_png's)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body)
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            assert body[8:] == b"\x08\x02\x00\x00\x00"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_render_frame_equals_tpusph_and_png_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    pos = np.concatenate([
        _start()["position"][:N],
        rng.uniform(-2.0, 12.0, (4000, 3)).astype(np.float32),  # some off frame
    ])
    img = render.render_frame(pos)
    ref = _render_frame_numpy(pos)
    assert img.dtype == np.uint8 and img.shape == (render.HEIGHT, render.WIDTH, 3)
    np.testing.assert_array_equal(img, ref)
    assert (img[..., 2] == 255).any() and (img == 255).all(axis=2).any()
    path = str(tmp_path / "f.png")
    render.save_png(img, path)
    np.testing.assert_array_equal(_png_pixels(path), img)


def test_free_mode_frames_match_tpusph_frames(tmp_path, monkeypatch):
    """run_free_mode's double-buffered loop renders frame k from the
    post-step-k positions: the port's frames equal tpusph's renders of
    tpusph's steps, with a click at frame 1."""
    js, ts = _pair()
    frames = {}
    monkeypatch.setattr(
        render, "_render_to",
        lambda p, k, out_dir: frames.__setitem__(k, render.render_frame(p)))
    render.run_free_mode(ts, frames=3, out_dir=str(tmp_path), clicks={1: CLICK_ON_FLUID})
    assert sorted(frames) == [0, 1, 2]
    for k in range(3):
        js.simulate(click=CLICK_ON_FLUID if k == 1 else None)
        np.testing.assert_array_equal(frames[k], _render_frame_numpy(js.get_position()))


def test_free_mode_sync_gives_the_same_frames(tmp_path, monkeypatch):
    """TPUSPH_VIZ_SYNC=1 (tpusph/viz/render.py:254-256) fetches each frame
    before the next step is dispatched: the same PNG files, byte for byte,
    as the double-buffered loop, and every fetch waited for before the next
    step."""
    def dump(folder, sync):
        if sync:
            monkeypatch.setenv("TPUSPH_VIZ_SYNC", "1")
        else:
            monkeypatch.delenv("TPUSPH_VIZ_SYNC", raising=False)
        _, ts = _pair()
        events = []
        simulate, fetch_async = ts.simulate, ts.get_position_async

        def traced_simulate(**kw):
            events.append("step")
            return simulate(**kw)

        def traced_fetch():
            fetch = fetch_async()
            wait = fetch.wait
            fetch.wait = lambda: (events.append("wait"), wait())[1]
            return fetch

        ts.simulate, ts.get_position_async = traced_simulate, traced_fetch
        render.run_free_mode(ts, frames=4, out_dir=str(folder), clicks={1: CLICK_ON_FLUID})
        files = sorted(os.listdir(folder))
        return events, {name: (folder / name).read_bytes() for name in files}

    events, overlapped = dump(tmp_path / "overlapped", sync=False)
    assert events == ["step", "step", "wait", "step", "wait", "step", "wait", "wait"]
    events, fetched = dump(tmp_path / "sync", sync=True)
    assert events == ["step", "wait"] * 4
    assert sorted(fetched) == [f"frame_{k:05d}.png" for k in range(4)]
    assert fetched == overlapped


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_simulator_takes_tpusph_backend_names(backend):
    """tpusph's `auto` (its default) and `pallas` are the port's `kernels`,
    for single steps, timed steps and chunks alike."""
    sims = {}
    for name in (backend, "kernels"):
        sim = Simulator(tdefault(N), backend=name, device="cpu")
        sim.setup()
        sim.simulate()
        sim.simulate_and_time(Times())
        sims[name] = (sim, sim.simulate_chunk(2))
    assert sims[backend][0].backend == "kernels"
    for a, b in zip(sims[backend][1], sims["kernels"][1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sims[backend][0].get_position(), sims["kernels"][0].get_position())


def test_unknown_backend_lists_the_names():
    with pytest.raises(ValueError) as err:
        Simulator(tdefault(N), backend="mosaic", device="cpu")
    for name in ("allpairs", "auto", "cell_list", "kernels", "pallas"):
        assert name in str(err.value)
    with pytest.raises(ValueError, match="cell_list"):
        make_step(tdefault(N), "mosaic", "cpu")


def test_free_mode_refuses_what_is_not_ported(monkeypatch, capsys):
    """Nothing of free mode is refused any more: frames=0 is the
    interactive window, which without a display prints tpusph's hint and
    returns, the state untouched."""
    _, ts = _pair()
    before = ts.get_position().copy()
    monkeypatch.delenv("DISPLAY", raising=False)
    render.run_free_mode(ts, frames=0)
    out = capsys.readouterr().out
    assert "No interactive display" in out and "--frames" in out
    np.testing.assert_array_equal(ts.get_position(), before)


def test_cli_free_mode_writes_frames(tmp_path, capsys):
    out = tmp_path / "frames"
    rc = cli.main(["-n", str(N), "-m", "free", "--frames", "3", "--click", "1:400,300",
                   "--out", str(out), "--device", "cpu"])
    assert rc == 0, capsys.readouterr().err
    files = sorted(os.listdir(out))
    assert files == ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    for name in files:
        img = _png_pixels(str(out / name))
        assert img.shape == (render.HEIGHT, render.WIDTH, 3) and (img[..., 2] == 255).any()


def _run(main, *args):
    assert main(["-n", "256", "-m", "time", "--warmup", "0", *args]) == 0


def _close(a, b):
    with np.load(a) as da, np.load(b) as db:
        for f in ("position", "velocity"):
            np.testing.assert_allclose(da[f], db[f], **GOLDEN)


def test_cli_checkpoints_cross_between_packages(tmp_path, capsys):
    """Mirror of tests/test_cli.py::test_checkpoint_roundtrip across the two
    packages: 2 steps in one, saved, loaded in the other and 2 more steps,
    equal 4 straight steps, both ways; within the port, bit for bit."""
    p = {k: str(tmp_path / f"{k}.npz") for k in ("t4", "t2", "t22", "j4", "j2", "tj", "jt")}
    cpu = ["--device", "cpu"]
    _run(cli.main, "--steps", "4", "--save", p["t4"], *cpu)
    _run(cli.main, "--steps", "2", "--save", p["t2"], *cpu)
    _run(cli.main, "--load", p["t2"], "--steps", "2", "--save", p["t22"], *cpu)
    _run(jcli.main, "--steps", "4", "--save", p["j4"])
    _run(jcli.main, "--steps", "2", "--save", p["j2"])
    _run(jcli.main, "--load", p["t2"], "--steps", "2", "--save", p["tj"])
    _run(cli.main, "--load", p["j2"], "--steps", "2", "--save", p["jt"], *cpu)
    with np.load(p["t4"]) as a, np.load(p["t22"]) as c:
        np.testing.assert_array_equal(a["position"], c["position"])
        np.testing.assert_array_equal(a["velocity"], c["velocity"])
    _close(p["tj"], p["j4"])
    _close(p["jt"], p["t4"])
    _close(p["t4"], p["j4"])
    assert "saved checkpoint" in capsys.readouterr().err
