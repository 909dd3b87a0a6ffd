"""Argument checks shared by the kernel wrappers, and the mark of a
kernel's plain version at work."""

from __future__ import annotations

import contextlib

import torch

_plain_depth = 0  # plain versions running now (they may nest)


@contextlib.contextmanager
def plain_version():
    """Around a kernel's plain version on the CPU. It stands for one launch,
    so the capture guard (`engine/graphs.py`) lets its own host reads
    through; the body around it stays guarded."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def in_plain_version() -> bool:
    return _plain_depth > 0


def on_cpu(device: torch.device) -> bool:
    """True for CPU tensors, which take a kernel's plain version; False for
    CUDA tensors, which launch the kernel. Any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}: expected cpu or cuda")
    return device.type == "cpu"


def check_tensor(name, t: torch.Tensor, dtype, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dim() != 1 and shape is None:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on `device`, for a C launch."""
    return torch.cuda.current_stream(device).cuda_stream
