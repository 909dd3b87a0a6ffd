"""Headless free mode: the host side of `tpusph/viz/render.py`, in place
of the reference's OpenGL/GLUT window (display.cpp).

The camera is the reference's: an 800×600 frame, black background, the
10×10×10 box wireframe in white, every particle a 3-px blue point, under
glFrustum(−2,2,−2,2,1,100) translated by (−5,−5,−15) (display.cpp:66-91).
Frames are rasterized on the host in numpy and written as PNG with a
stdlib encoder (zlib), so no imaging package is needed.

The frame loop is double-buffered like tpusph's: step k+1 is queued on the
card before the host waits on the copy of step k's positions, so the copy
and the rendering overlap the next step.

Not ported yet: the chunked frame loop (`_run_chunked`), the device
projections of `tpusph/viz/project.py`, the native rasterizer, the
interactive matplotlib window and `--gif`.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

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


def render_frame(positions: np.ndarray) -> np.ndarray:
    """One frame, uint8[H, W, 3] (display.cpp:35-57); the same bytes as
    tpusph's `_render_frame_numpy`. Particle centres at least 1 px inside
    the frame and in front of the near plane mark an occupancy mask, which
    a separable 3×3 dilation turns into the 3-px points (tpusph's
    `_paint_blue_3px`): every point paints the same colour, so the union of
    the 3×3 blocks is all that shows."""
    img = _wireframe_layer().copy()
    px, z = project(positions)
    inside = (
        (px[:, 0] >= 1) & (px[:, 0] < WIDTH - 1)
        & (px[:, 1] >= 1) & (px[:, 1] < HEIGHT - 1) & (z > NEAR)
    )
    mask = np.zeros((HEIGHT, WIDTH), bool)
    mask[px[inside, 1].astype(np.int32), px[inside, 0].astype(np.int32)] = True
    v = mask.copy()
    v[:-1] |= mask[1:]
    v[1:] |= mask[:-1]
    d = v.copy()
    d[:, :-1] |= v[:, 1:]
    d[:, 1:] |= v[:, :-1]
    img[d] = (0, 0, 255)
    return img


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


def run_free_mode(sim, frames: int = 0, out_dir: str = "frames", clicks=None) -> None:
    """Free mode as a headless frame dump: `frames` steps, each followed by
    a PNG of its positions in `out_dir`, with scripted clicks
    {frame: (px, py)} applied to that frame's step. frames == 0 (the
    interactive window) is not ported."""
    if frames <= 0:
        raise NotImplementedError(f"interactive free mode is {NOT_PORTED}; pass frames > 0")
    clicks = clicks or {}
    os.makedirs(out_dir, exist_ok=True)
    # Frame k always renders the post-step-k positions; only the wait moves
    # behind the next step.
    pending = None  # (frame index, fetch in flight)
    for k in range(frames):
        sim.simulate(click=clicks.get(k))
        fetch = sim.get_position_async()
        if pending is not None:
            _render_to(pending[1].wait(), pending[0], out_dir)
        pending = (k, fetch)
    _render_to(pending[1].wait(), pending[0], out_dir)
    print(f"wrote {frames} frames to {out_dir}/")
