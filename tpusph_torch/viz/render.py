"""Headless free mode: the host side of `tpusph/viz/render.py`, in place
of the reference's OpenGL/GLUT window (display.cpp).

The camera is the reference's: an 800×600 frame, black background, the
10×10×10 box wireframe in white, every particle a 3-px blue point, under
glFrustum(−2,2,−2,2,1,100) translated by (−5,−5,−15) (display.cpp:66-91).
Frames are rasterized on the host, by the native library
(`utils/native.py`) where it builds and in numpy otherwise, the same bytes
either way, and written as PNG with a stdlib encoder (zlib). `--gif`
assembles them with PIL where it imports and with a stdlib GIF89a writer
otherwise, so no imaging package is needed.

The frame loop is double-buffered like tpusph's: step k+1 is queued on the
card before the host waits on the copy of step k's positions, so the copy
and the rendering overlap the next step. With `chunk=S` (or
TPUSPH_VIZ_CHUNK=S) free mode runs S steps per dispatch (`_run_chunked`)
and the frames are made on the card (`viz/project.py`): packed pixels or
occupancy bitmaps, drawn here by `render_frame_packed` and
`render_frame_bitmap`, byte-equal to `render_frame`.

`frames == 0` is the interactive matplotlib window (`_run_interactive`),
with the reference's left-click ripple wiring (display.cpp:22-32); with no
display it prints a hint and returns.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

WIDTH, HEIGHT = 800, 600  # display.cpp:72
NEAR, FRUSTUM_HALF = 1.0, 2.0  # glFrustum(-2,2,-2,2,1,100), display.cpp:85
CAMERA_OFFSET = np.array([-5.0, -5.0, -15.0], np.float32)  # display.cpp:86

_BOX_VERTICES = np.array(
    [
        [0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 10, 0],
        [0, 0, 10], [10, 0, 10], [10, 10, 10], [0, 10, 10],
    ],
    np.float32,
)  # display.cpp:10-13
_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
    (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7),
]  # display.cpp:15-16


def project(points: np.ndarray):
    """World → pixel coordinates under the reference camera: f32[N, 2]
    (x right, y down) and the view-space depth f32[N]."""
    view = points.astype(np.float32) + CAMERA_OFFSET
    z = -view[:, 2]  # the camera looks down -z; z > 0 in front
    z = np.maximum(z, 1e-6)
    ndc_x = (NEAR * view[:, 0] / z) / FRUSTUM_HALF
    ndc_y = (NEAR * view[:, 1] / z) / FRUSTUM_HALF
    px = (ndc_x * 0.5 + 0.5) * WIDTH
    py = (1.0 - (ndc_y * 0.5 + 0.5)) * HEIGHT
    return np.stack([px, py], axis=1), z


@functools.cache
def _wireframe_layer() -> np.ndarray:
    """uint8[H, W, 3]: the black frame with the white box wireframe, the
    same in every frame (each edge sampled at 400 points). Callers copy it
    before drawing on it."""
    img = np.zeros((HEIGHT, WIDTH, 3), np.uint8)
    for a, b in _BOX_EDGES:
        t = np.linspace(0.0, 1.0, 400, dtype=np.float32)[:, None]
        seg = _BOX_VERTICES[a][None, :] * (1 - t) + _BOX_VERTICES[b][None, :] * t
        px, _ = project(seg)
        xi = np.clip(px[:, 0].astype(np.int32), 0, WIDTH - 1)
        yi = np.clip(px[:, 1].astype(np.int32), 0, HEIGHT - 1)
        img[yi, xi] = 255
    return img


def _paint_blue_3px(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Dilate the pixel-occupancy mask by the 3×3 point footprint (separable
    shift-OR) and paint it blue over img, in place (tpusph's
    `_paint_blue_3px`): every point paints the same colour, so the union of
    the 3×3 blocks is all that shows."""
    v = mask.copy()
    v[:-1] |= mask[1:]
    v[1:] |= mask[:-1]
    d = v.copy()
    d[:, :-1] |= v[:, 1:]
    d[:, 1:] |= v[:, :-1]
    img[d] = (0, 0, 255)
    return img


def render_frame(positions: np.ndarray) -> np.ndarray:
    """One frame, uint8[H, W, 3] (display.cpp:35-57), from the native
    rasterizer where the library is there, else `_render_frame_numpy`: the
    same bytes."""
    from tpusph_torch.utils.native import render_frame_native

    native = render_frame_native(positions)
    return native if native is not None else _render_frame_numpy(positions)


def _render_frame_numpy(positions: np.ndarray) -> np.ndarray:
    """render_frame in numpy; the same bytes as tpusph's
    `_render_frame_numpy`. Particle centres at least 1 px inside the frame
    and in front of the near plane mark an occupancy mask, which the
    dilation turns into the 3-px points."""
    px, z = project(positions)
    inside = (
        (px[:, 0] >= 1) & (px[:, 0] < WIDTH - 1)
        & (px[:, 1] >= 1) & (px[:, 1] < HEIGHT - 1) & (z > NEAR)
    )
    mask = np.zeros((HEIGHT, WIDTH), bool)
    mask[px[inside, 1].astype(np.int32), px[inside, 0].astype(np.int32)] = True
    return _paint_blue_3px(_wireframe_layer().copy(), mask)


def render_frame_packed(packed: np.ndarray) -> np.ndarray:
    """One frame from device-projected packed pixels (int32[N], see
    `viz/project.py`); the same bytes as render_frame of the positions,
    from the native rasterizer or `_render_frame_packed_numpy`."""
    from tpusph_torch.utils.native import render_packed_native

    native = render_packed_native(packed)
    return native if native is not None else _render_frame_packed_numpy(packed)


def _render_frame_packed_numpy(packed: np.ndarray) -> np.ndarray:
    from tpusph_torch.viz.project import PACK_INSIDE

    p = packed[(packed & PACK_INSIDE) != 0]
    mask = np.zeros((HEIGHT, WIDTH), bool)
    mask[(p >> 10) & 0x3FF, p & 0x3FF] = True
    return _paint_blue_3px(_wireframe_layer().copy(), mask)


def render_frame_bitmap(bits: np.ndarray) -> np.ndarray:
    """One frame from a device occupancy bitmap (uint8[H, W/8], little bit
    order, `viz/project.py::project_bitmap`); the same bytes as
    render_frame_packed of the same positions."""
    mask = np.unpackbits(np.asarray(bits, np.uint8), axis=-1, bitorder="little").astype(bool)
    return _paint_blue_3px(_wireframe_layer().copy(), mask)


def save_png(img: np.ndarray, path: str) -> None:
    """Write uint8[H, W, 3] as an 8-bit RGB PNG. zlib level 1: PNG is
    lossless at every level, and level 1 encodes these mostly black frames
    several times faster than the default 6 for a somewhat larger file."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data))
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 1))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def _render_to(positions: np.ndarray, k: int, out_dir: str) -> None:
    save_png(render_frame(positions), os.path.join(out_dir, f"frame_{k:05d}.png"))


def run_free_mode(
    sim, frames: int = 0, out_dir: str = "frames", clicks=None, chunk: int | None = None
) -> None:
    """Free mode (display() callback loop, display.cpp:35-64). frames > 0:
    a headless frame dump, `frames` steps, each followed by a PNG of its
    positions in `out_dir`, with scripted clicks {frame: (px, py)} applied
    to that frame's step; chunk=S (default TPUSPH_VIZ_CHUNK, else
    unchunked) runs S steps per dispatch, see `_run_chunked`. frames == 0:
    the interactive window with live left-click ripple impulses. A
    simulator without `dispatch_chunk` (`DistSimulator`) runs unchunked,
    and one without `get_position_async` collects each frame's positions
    synchronously, as tpusph does."""
    if frames <= 0:
        _run_interactive(sim)
        return
    clicks = clicks or {}
    os.makedirs(out_dir, exist_ok=True)
    if chunk is None:
        chunk = int(os.environ.get("TPUSPH_VIZ_CHUNK", "0"))
    if chunk > 1 and hasattr(sim, "dispatch_chunk"):
        _run_chunked(sim, frames, chunk, clicks, out_dir)
        return
    # Frame k always renders the post-step-k positions; only the wait moves
    # behind the next step. TPUSPH_VIZ_SYNC=1 (tpusph's measuring aid) takes
    # the overlap away: each frame is fetched and drawn before the next step
    # is dispatched.
    sync = bool(os.environ.get("TPUSPH_VIZ_SYNC"))
    overlap = hasattr(sim, "get_position_async")
    pending = None  # (frame index, fetch in flight)
    for k in range(frames):
        sim.simulate(click=clicks.get(k))
        if not overlap:  # DistSimulator: a synchronous collect
            _render_to(sim.get_position(), k, out_dir)
            continue
        fetch = sim.get_position_async()
        if pending is not None:
            _render_to(pending[1].wait(), pending[0], out_dir)
        if sync:
            _render_to(fetch.wait(), k, out_dir)
        else:
            pending = (k, fetch)
    if pending is not None:
        _render_to(pending[1].wait(), pending[0], out_dir)
    print(f"wrote {frames} frames to {out_dir}/")


def frame_pack(num_particles: int):
    """The frame stream of the chunked loop: TPUSPH_VIZ_PACK=bitmap (device
    occupancy bitmaps, 60 KB a frame; the default at N ≥ 65,536), =1
    (packed pixels, 4 bytes a particle; the default below) or =0 (raw
    positions, 12 bytes a particle)."""
    default = "bitmap" if num_particles >= 65536 else "1"
    mode = os.environ.get("TPUSPH_VIZ_PACK", default)
    return {"0": False, "1": True}.get(mode, "bitmap")


def _run_chunked(sim, frames: int, chunk: int, clicks, out_dir: str) -> None:
    """S steps per dispatch (`Simulator.dispatch_chunk`), two chunks in
    flight: the frame stack of one chunk crosses to the host while the next
    one runs. Scripted clicks fire at their frame inside the chunk, so the
    frames equal the sequential loop's. On overflow the oldest chunk rewinds
    to its pre-state, the newer one is dropped, and both replay with grown
    capacity. PNG encodes run on two worker threads (zlib releases the
    interpreter lock); only committed chunks are encoded, so no file needs
    un-writing."""
    pack = frame_pack(sim.cfg.num_particles)
    draw = {"bitmap": render_frame_bitmap, True: render_frame_packed, False: render_frame}[pack]
    inflight: list = []  # (start frame, ChunkHandle), oldest first
    k = 0  # next frame to dispatch
    done = 0
    with ThreadPoolExecutor(max_workers=2) as pool:
        saves = []
        while done < frames:
            while k < frames and len(inflight) < 2:
                s = min(chunk, frames - k)
                local = {j - k: clicks[j] for j in range(k, k + s) if j in clicks}
                inflight.append((k, sim.dispatch_chunk(s, local, pack_pixels=pack)))
                k += s
            start, handle = inflight.pop(0)
            snaps, ovf = handle.fetch.wait()
            if ovf:
                sim.rewind_chunk(handle)
                inflight.clear()
                k = start
                continue
            for j in range(handle.n_steps):
                path = os.path.join(out_dir, f"frame_{start + j:05d}.png")
                saves.append(pool.submit(save_png, draw(snaps[j]), path))
                done += 1
        for f in saves:
            f.result()  # raise an encode's error here
    print(f"wrote {frames} frames to {out_dir}/")


# --------------------------------------------------------- interactive window


def _build_interactive(sim):
    """The interactive window's pieces: (fig, tick, pending). `tick` is the
    per-frame FuncAnimation callback (the queued click is consumed like the
    reference's mouseClicked global, display.cpp:59-61);
    `pending["click"]` injects a click the way the button_press_event
    handler does. Apart from `_run_interactive` so that a headless test
    (matplotlib Agg) can drive real ticks without a display.

    The default tick is pipelined: it dispatches this tick's step, with the
    click queued at this tick, and then draws the frame of the tick
    TPUSPH_VIZ_DEPTH (default 2) ticks back, encoded on the device
    (`frame_pack`), while the new step runs. The window shows that many
    frames behind the physics. A step that overflowed rewinds to its
    pre-state, replays through `simulate`'s grow-and-retry, and the younger
    ticks are dispatched again in order. TPUSPH_VIZ_SYNC=1 is the
    sequential simulate, fetch, render tick, and so is a simulator without
    `dispatch_chunk` (`DistSimulator`)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    if fig.canvas.manager is not None:  # Agg has no window manager
        fig.canvas.manager.set_window_title("SPH Simulation")  # display.cpp:73
    im = ax.imshow(render_frame(sim.get_position()))
    ax.set_axis_off()
    pending = {"click": None}

    def on_click(event):  # mouse() callback parity (display.cpp:22-32)
        if event.button == 1 and event.xdata is not None:
            pending["click"] = (int(event.xdata), int(event.ydata))

    fig.canvas.mpl_connect("button_press_event", on_click)

    sync = os.environ.get("TPUSPH_VIZ_SYNC") == "1" or not hasattr(
        sim, "dispatch_chunk"  # DistSimulator: the sequential tick only
    )
    pack = frame_pack(sim.cfg.num_particles)
    draw = {"bitmap": render_frame_bitmap, True: render_frame_packed, False: render_frame}[pack]
    depth = max(1, int(os.environ.get("TPUSPH_VIZ_DEPTH", "2")))
    inflight: list = []  # (ChunkHandle, click), oldest first

    def dispatch(click):
        return sim.dispatch_chunk(1, {0: click} if click else None, pack_pixels=pack)

    def tick(_frame):
        click = pending["click"]
        pending["click"] = None
        if sync:
            sim.simulate(click=click)
            im.set_data(render_frame(sim.get_position()))
            return (im,)
        inflight.append((dispatch(click), click))
        if len(inflight) > depth:
            prev, prev_click = inflight.pop(0)
            snaps, ovf = prev.fetch.wait()
            if ovf:
                # every younger dispatch consumed a clipped state
                sim.rewind_chunk(prev)
                sim.simulate(click=prev_click)
                im.set_data(render_frame(sim.get_position()))
                inflight[:] = [(dispatch(c), c) for _, c in inflight]
            else:
                im.set_data(draw(snaps[0]))
        return (im,)

    return fig, tick, pending


def _run_interactive(sim) -> None:
    try:
        if not os.environ.get("DISPLAY") and os.name == "posix":
            raise RuntimeError("no display")
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation
    except Exception:
        print(
            "No interactive display available; use --frames N to dump frames "
            "headlessly (e.g. sph -m free --frames 100 --out frames/)."
        )
        return

    fig, tick, _pending = _build_interactive(sim)
    _anim = FuncAnimation(fig, tick, interval=1, blit=True, cache_frame_data=False)
    plt.show()


# ------------------------------------------------------------------------ GIF

# the three colours the raster paints, and a fourth entry to fill the
# 2-bit colour table
GIF_PALETTE = ((0, 0, 0), (255, 255, 255), (0, 0, 255), (0, 0, 0))


def read_png(path: str) -> np.ndarray:
    """uint8[H, W, 3] from a PNG as `save_png` writes it: 8-bit RGB, not
    interlaced, every row with filter 0. Anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, shape = 8, [], None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: only 8-bit RGB, not interlaced, is read")
            shape = (h, w)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    h, w = shape
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter 0 rows are read")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _palette_indices(img: np.ndarray) -> bytes:
    """Palette index of every pixel, row by row; a colour outside
    GIF_PALETTE raises."""
    rgb = img.astype(np.uint32)
    code = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    idx = np.full(code.shape, 255, np.uint8)
    for i, (r, g, b) in enumerate(GIF_PALETTE[:3]):
        idx[code == ((r << 16) | (g << 8) | b)] = i
    if (idx == 255).any():
        y, x = np.argwhere(idx == 255)[0]
        raise ValueError(f"colour {tuple(img[y, x])} at ({x}, {y}) is not in the GIF palette")
    return idx.tobytes()


def _lzw_encode(indices: bytes, min_code_size: int = 2) -> bytes:
    """GIF's variable-width LZW of a palette-index stream: codes from
    min_code_size + 1 up to 12 bits, packed low bit first; the table is
    cleared when it is full."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    table: dict[int, int] = {}
    next_code, size = eoi + 1, min_code_size + 1

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            if next_code == 1 << size:
                size += 1
            next_code += 1
        else:
            emit(clear)
            table.clear()
            next_code, size = eoi + 1, min_code_size + 1
        prefix = k
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(images, gif_path: str, fps: int = 30) -> None:
    """An animated GIF89a of uint8[H, W, 3] frames in GIF_PALETTE's
    colours, with the stdlib alone: one global palette, looping for ever,
    int(1000 / fps) ms a frame (GIF counts hundredths of a second)."""
    images = list(images)
    if not images:
        raise ValueError("no frames")
    h, w, _ = images[0].shape
    delay = int(1000 / fps) // 10
    parts = [
        b"GIF89a",
        struct.pack("<HHBBB", w, h, 0x91, 0, 0),  # global table of 4, 2 bits a colour
        bytes(c for rgb in GIF_PALETTE for c in rgb),
        b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00",  # loop=0
    ]
    for img in images:
        if img.shape != (h, w, 3):
            raise ValueError(f"frame of shape {img.shape}, expected {(h, w, 3)}")
        data = _lzw_encode(_palette_indices(img))
        parts.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, delay, 0, 0))
        parts.append(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
        parts.append(b"\x02")  # LZW minimum code size
        for a in range(0, len(data), 255):
            block = data[a : a + 255]
            parts.append(bytes([len(block)]) + block)
        parts.append(b"\x00")
    parts.append(b"\x3b")
    with open(gif_path, "wb") as f:
        f.write(b"".join(parts))


def _frame_paths(frames_dir: str) -> list[str]:
    paths = sorted(
        os.path.join(frames_dir, f) for f in os.listdir(frames_dir) if f.endswith(".png")
    )
    if not paths:
        raise ValueError(f"no frames in {frames_dir}")
    return paths


def _frames_to_gif_pil(paths: list[str], gif_path: str, fps: int) -> None:
    from PIL import Image

    imgs = [Image.open(p) for p in paths]
    imgs[0].save(
        gif_path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0
    )


def _frames_to_gif_stdlib(paths: list[str], gif_path: str, fps: int) -> None:
    write_gif((read_png(p) for p in paths), gif_path, fps)


def frames_to_gif(frames_dir: str, gif_path: str, fps: int = 30) -> None:
    """Assemble the PNG frames in frames_dir into an animated GIF: with PIL
    where it imports, else with `write_gif`; the same pictures either way.
    PIL folds a frame equal to the one before it into that frame's
    duration, `write_gif` writes every frame."""
    paths = _frame_paths(frames_dir)
    try:
        import PIL  # noqa: F401
    except ImportError:
        _frames_to_gif_stdlib(paths, gif_path, fps)
    else:
        _frames_to_gif_pil(paths, gif_path, fps)
