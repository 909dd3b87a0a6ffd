"""Entry points of the rate probes, the counterparts of
`scripts/vpu_microbench.py` and `scripts/loop_probe.py`:

    python -m tpusph_torch.scripts.vpu_microbench
    python -m tpusph_torch.scripts.loop_probe [pt] [bl]

They time the card and need one; each rate is the slope over the round
count of the min-over-reps time of one call, from CUDA events recorded
around the launch.
"""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The card the probes time; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time a GPU: torch.cuda is not available")
    return torch.device("cuda", 0)


def timed(fn, reps: int) -> float:
    """Seconds of one call of `fn`: CUDA events recorded around it on the
    current stream, min over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def slope(t_lo: float, t_hi: float, rounds_lo: int, rounds_hi: int) -> float:
    """Seconds per round between two timed round counts; raises unless
    positive (a slope at or below 0 measures noise, not the loop)."""
    dt = (t_hi - t_lo) / (rounds_hi - rounds_lo)
    if not dt > 0:
        raise RuntimeError(
            f"slope not positive: {t_lo:.3e} s at {rounds_lo} rounds, "
            f"{t_hi:.3e} s at {rounds_hi} rounds"
        )
    return dt
