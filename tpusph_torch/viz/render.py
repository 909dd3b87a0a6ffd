"""Headless free mode: the host side of `tpusph/viz/render.py`, in place
of the reference's OpenGL/GLUT window (display.cpp).

The camera is the reference's: an 800×600 frame, black background, the
10×10×10 box wireframe in white, every particle a 3-px blue point, under
glFrustum(−2,2,−2,2,1,100) translated by (−5,−5,−15) (display.cpp:66-91).
Frames are rasterized on the host in numpy and written as PNG with a
stdlib encoder (zlib), so no imaging package is needed.

The frame loop is double-buffered like tpusph's: step k+1 is queued on the
card before the host waits on the copy of step k's positions, so the copy
and the rendering overlap the next step. With `chunk=S` (or
TPUSPH_VIZ_CHUNK=S) free mode runs S steps per dispatch (`_run_chunked`)
and the frames are made on the card (`viz/project.py`): packed pixels or
occupancy bitmaps, drawn here by `render_frame_packed` and
`render_frame_bitmap`, byte-equal to `render_frame`.

Not ported yet: the native rasterizer, the interactive matplotlib window
and `--gif`.
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

NOT_PORTED = "not yet ported to tpusph_torch"

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
    """One frame, uint8[H, W, 3] (display.cpp:35-57); the same bytes as
    tpusph's `_render_frame_numpy`. Particle centres at least 1 px inside
    the frame and in front of the near plane mark an occupancy mask, which
    the dilation turns into the 3-px points."""
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
    `viz/project.py`); the same bytes as render_frame of the positions."""
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
    """Free mode as a headless frame dump: `frames` steps, each followed by
    a PNG of its positions in `out_dir`, with scripted clicks
    {frame: (px, py)} applied to that frame's step. chunk=S (default
    TPUSPH_VIZ_CHUNK, else unchunked) runs S steps per dispatch, see
    `_run_chunked`. frames == 0 (the interactive window) is not ported."""
    if frames <= 0:
        raise NotImplementedError(f"interactive free mode is {NOT_PORTED}; pass frames > 0")
    clicks = clicks or {}
    os.makedirs(out_dir, exist_ok=True)
    if chunk is None:
        chunk = int(os.environ.get("TPUSPH_VIZ_CHUNK", "0"))
    if chunk > 1:
        _run_chunked(sim, frames, chunk, clicks, out_dir)
        return
    # Frame k always renders the post-step-k positions; only the wait moves
    # behind the next step. TPUSPH_VIZ_SYNC=1 (tpusph's measuring aid) takes
    # the overlap away: each frame is fetched and drawn before the next step
    # is dispatched.
    sync = bool(os.environ.get("TPUSPH_VIZ_SYNC"))
    pending = None  # (frame index, fetch in flight)
    for k in range(frames):
        sim.simulate(click=clicks.get(k))
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
