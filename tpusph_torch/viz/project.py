"""Frame projections on the device for free mode. Counterpart of
`tpusph/viz/project.py`.

The reference renders on its device (the OpenGL vertex transform,
display.cpp:83-91). Here each step's frame is made on the card and only
the frame crosses to the host:
  * project_pixels_packed: one int32 per particle, its pixel under the
    reference camera: bit 20 the inside-frame flag, bits 19..10 y, bits
    9..0 x (800×600: x, y < 1024); outside particles pack to 0.
  * project_bitmap: the bit-packed pixel occupancy, uint8[H, W/8] (little
    bit order), 60 KB a frame whatever N is. Uniform 3-px points carry
    nothing but occupancy, so render.render_frame_bitmap draws the same
    frame as render.render_frame_packed.

The float32 ops and their order are `render.project`'s. A divisor is a
tensor or 2.0 (a python-float divisor is a multiply by its reciprocal on
CUDA, exact only for a power of two). Nothing here reads the host or
copies from it, so a chunk captured in a CUDA graph can make its frames.
"""

from __future__ import annotations

import torch

from tpusph_torch.core.config import f32
from tpusph_torch.viz.render import FRUSTUM_HALF, HEIGHT, NEAR, WIDTH

PACK_INSIDE = 1 << 20


def project_pixels_packed(position: torch.Tensor) -> torch.Tensor:
    """f32[N, 3] world positions → packed int32[N] pixels (see above); the
    inside test is render_frame's."""
    view_x = position[:, 0] + f32(-5.0)
    view_y = position[:, 1] + f32(-5.0)
    view_z = position[:, 2] + f32(-15.0)
    z = torch.clamp(-view_z, min=f32(1e-6))
    ndc_x = (NEAR * view_x / z) / FRUSTUM_HALF
    ndc_y = (NEAR * view_y / z) / FRUSTUM_HALF
    px = (ndc_x * 0.5 + 0.5) * WIDTH
    py = (1.0 - (ndc_y * 0.5 + 0.5)) * HEIGHT
    inside = (px >= 1) & (px < WIDTH - 1) & (py >= 1) & (py < HEIGHT - 1) & (z > NEAR)
    packed = px.to(torch.int32) | (py.to(torch.int32) << 10) | PACK_INSIDE
    return torch.where(inside, packed, 0)


def project_bitmap(position: torch.Tensor) -> torch.Tensor:
    """f32[N, 3] positions of LIVE particles → uint8[HEIGHT, WIDTH // 8]
    occupancy, bit b of byte (y, k) the pixel (y, 8k + b)."""
    packed = project_pixels_packed(position)
    inside = (packed & PACK_INSIDE) != 0
    flat = ((packed >> 10) & 0x3FF) * WIDTH + (packed & 0x3FF)
    idx = torch.where(inside, flat, HEIGHT * WIDTH).long()  # outside → scratch slot
    grid = torch.zeros(HEIGHT * WIDTH + 1, dtype=torch.int32, device=position.device)
    grid.index_fill_(0, idx, 1)
    bits = grid[: HEIGHT * WIDTH].reshape(HEIGHT, WIDTH // 8, 8)
    weights = torch.arange(8, dtype=torch.int32, device=position.device)
    return (bits << weights).sum(dim=-1, dtype=torch.int32).to(torch.uint8)
