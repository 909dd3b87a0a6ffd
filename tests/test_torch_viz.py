"""The port's interactive window and GIF assembly (`tpusph_torch/viz/
render.py`), driven as `tests/test_viz.py` drives tpusph's: real ticks
under matplotlib's Agg backend, and the no-display branch."""

import os

import numpy as np
import pytest
from PIL import Image

from tpusph_torch import cli
from tpusph_torch.core.config import default_config
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.viz import render

CLICK_ON_FLUID = (206, 442)  # a pixel whose click cell holds grid-init particles


def _make_sim(n=512):
    sim = Simulator(default_config(n), backend="cell_list", device="cpu")
    sim.setup()
    return sim


def _agg():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    return plt


def test_interactive_fallback_without_display(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    render._run_interactive(_make_sim())
    out = capsys.readouterr().out
    assert "No interactive display" in out and "--frames" in out


def test_cli_free_mode_without_display_returns_0(monkeypatch, capsys):
    """`-m free` without `--frames` and without a display prints tpusph's
    hint and exits 0."""
    monkeypatch.delenv("DISPLAY", raising=False)
    assert cli.main(["-n", "256", "-m", "free", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "No interactive display available; use --frames N" in out


def test_interactive_tick_under_agg():
    """One real tick under Agg advances the simulation, consumes the queued
    click exactly once and refreshes the image."""
    plt = _agg()
    sim = _make_sim()
    p0 = sim.get_position().copy()
    fig, tick, pending = render._build_interactive(sim)
    try:
        pending["click"] = CLICK_ON_FLUID
        (im,) = tick(0)
        assert pending["click"] is None
        p1 = sim.get_position()
        assert np.abs(p1 - p0).max() > 0
        assert im.get_array().shape[:2] == (render.HEIGHT, render.WIDTH)
        tick(1)
        assert np.abs(sim.get_position() - p1).max() > 0
    finally:
        plt.close(fig)


@pytest.mark.parametrize("pack", ["0", "1", "bitmap"])
@pytest.mark.parametrize("depth", [1, 2])
def test_interactive_pipelined_matches_sync(monkeypatch, depth, pack):
    """The pipelined tick runs the same step and click trajectory as the
    sequential tick (TPUSPH_VIZ_SYNC=1), the image `depth` frames behind,
    whatever the frame encoding."""
    plt = _agg()
    click_at = {1: CLICK_ON_FLUID}

    monkeypatch.setenv("TPUSPH_VIZ_SYNC", "1")
    ref = _make_sim()
    fig_r, tick_r, pend_r = render._build_interactive(ref)
    ref_frames = []
    for k in range(5):
        pend_r["click"] = click_at.get(k)
        (im_r,) = tick_r(k)
        ref_frames.append(np.asarray(im_r.get_array()).copy())
    plt.close(fig_r)
    assert not np.array_equal(ref_frames[0], ref_frames[4])

    plain = _make_sim()  # the loop without a window
    for k in range(5):
        plain.simulate(click=click_at.get(k))
    np.testing.assert_array_equal(ref.get_position(), plain.get_position())
    np.testing.assert_array_equal(ref_frames[4], render.render_frame(plain.get_position()))

    monkeypatch.delenv("TPUSPH_VIZ_SYNC")
    monkeypatch.setenv("TPUSPH_VIZ_DEPTH", str(depth))
    monkeypatch.setenv("TPUSPH_VIZ_PACK", pack)
    sim = _make_sim()
    fig, tick, pending = render._build_interactive(sim)
    try:
        for k in range(5):
            pending["click"] = click_at.get(k)
            (im,) = tick(k)
            assert pending["click"] is None
            if k >= depth:  # shows step (k - depth)'s frame
                np.testing.assert_array_equal(
                    np.asarray(im.get_array()), ref_frames[k - depth], err_msg=f"tick {k}"
                )
        np.testing.assert_array_equal(sim.get_position(), ref.get_position())
    finally:
        plt.close(fig)


def test_interactive_overflow_rewinds_and_replays(monkeypatch):
    """A tick whose step overflowed the tile passes' capacity rewinds,
    replays with grown capacity and dispatches the younger ticks again: the
    positions end where the loop without a window ends."""
    import dataclasses

    plt = _agg()
    want = _make_sim()
    for _ in range(4):
        want.simulate()
    sim = Simulator(
        dataclasses.replace(default_config(512), tile_cand_capacity=8),
        backend="cell_list", device="cpu",
    )
    sim.setup()
    monkeypatch.setenv("TPUSPH_VIZ_DEPTH", "1")
    fig, tick, _ = render._build_interactive(sim)
    try:
        for k in range(4):
            tick(k)
        assert sim.cfg.tile_cand_capacity > 8
        np.testing.assert_allclose(sim.get_position(), want.get_position(), rtol=1e-5, atol=1e-6)
    finally:
        plt.close(fig)


# ------------------------------------------------------------------------ GIF


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("frames")
    rc = cli.main(["-n", "512", "-m", "free", "--frames", "4", "--click", "1:206,442",
                   "--out", str(out), "--device", "cpu"])
    assert rc == 0
    return out


def _gif_frames(path) -> list:
    with Image.open(path) as gif:
        assert gif.format == "GIF" and gif.info["loop"] == 0
        frames = []
        for k in range(gif.n_frames):
            gif.seek(k)
            assert gif.info["duration"] == 30  # int(1000 / 30) ms in GIF's hundredths
            frames.append(np.asarray(gif.convert("RGB")))
        return frames


def _png_frames(frames_dir) -> list:
    paths = render._frame_paths(str(frames_dir))
    assert len(paths) == 4
    return [np.asarray(Image.open(p).convert("RGB")) for p in paths]


@pytest.mark.parametrize("writer", ["stdlib", "pil"])
def test_gif_frames_equal_the_pngs(frames_dir, tmp_path, writer):
    """Both writers, read back frame by frame with PIL, give the PNGs pixel
    for pixel; the stdlib writer's file is a looping GIF89a."""
    path = tmp_path / "out.gif"
    write = {"stdlib": render._frames_to_gif_stdlib, "pil": render._frames_to_gif_pil}[writer]
    write(render._frame_paths(str(frames_dir)), str(path), 30)
    assert path.read_bytes()[:6] == b"GIF89a"
    got, want = _gif_frames(path), _png_frames(frames_dir)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(want[0], want[3])


def test_png_reader_reads_what_save_png_wrote(frames_dir, tmp_path):
    for path, want in zip(render._frame_paths(str(frames_dir)), _png_frames(frames_dir)):
        np.testing.assert_array_equal(render.read_png(path), want)
    grey = tmp_path / "grey.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(grey)
    with pytest.raises(ValueError, match="8-bit RGB"):
        render.read_png(str(grey))


def test_gif_writer_on_a_busy_frame_and_off_palette(tmp_path):
    """A frame of palette noise fills the LZW table many times over (the
    clear code path); a colour outside the palette raises."""
    rng = np.random.default_rng(0)
    palette = np.array(render.GIF_PALETTE[:3], np.uint8)
    noise = palette[rng.integers(0, 3, size=(120, 160))]
    flat = np.zeros((120, 160, 3), np.uint8)
    path = tmp_path / "noise.gif"
    render.write_gif([noise, flat, noise[::-1].copy()], str(path), fps=10)
    with Image.open(path) as gif:
        assert gif.n_frames == 3 and gif.size == (160, 120) and gif.info["duration"] == 100
        for k, want in enumerate([noise, flat, noise[::-1]]):
            gif.seek(k)
            np.testing.assert_array_equal(np.asarray(gif.convert("RGB")), want)
    noise[5, 7] = (255, 0, 0)
    with pytest.raises(ValueError, match="not in the GIF palette"):
        render.write_gif([noise], str(path))
    with pytest.raises(ValueError, match="no frames"):
        render.write_gif([], str(path))
    os.remove(path)
    with pytest.raises(ValueError, match="no frames in"):
        render.frames_to_gif(str(tmp_path), str(path))


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "no_pil"])
def test_cli_gif(tmp_path, capsys, monkeypatch, pil):
    """`--gif` through `cli.main`, with PIL and with its import failing
    (the stdlib writer, as on a machine without PIL): the same frames."""
    if not pil:
        import builtins

        real = builtins.__import__

        def no_pil(name, *a, **k):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError("no PIL here")
            return real(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_pil)
    out, gif = tmp_path / "frames", tmp_path / "run.gif"
    rc = cli.main(["-n", "512", "-m", "free", "--frames", "3", "--out", str(out),
                   "--gif", str(gif), "--device", "cpu"])
    monkeypatch.undo()
    assert rc == 0
    assert f"wrote {gif}" in capsys.readouterr().out
    got = _gif_frames(gif)
    assert len(got) == 3
    for a, path in zip(got, render._frame_paths(str(out))):
        np.testing.assert_array_equal(a, render.read_png(path))
