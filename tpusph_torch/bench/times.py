"""Phase timing, the reference's `struct Times` / `displayTimes`
(times.h:5-36). Counterpart of `tpusph/bench/times.py`: the same fields
and the same table layout. Seconds accumulate for the three phases the
reference fences with cudaDeviceSynchronize: grid construction, SPH
update, data transfer."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Times:
    """Seconds of the timed steps that stood, and their count. On the
    kernels backend `Simulator.simulate_and_time` waits for the previous
    copy and starts the next inside the update's interval, so there
    `sph_update` holds `memcpy`: the two fields overlap. On the tile passes
    the three phases follow each other."""

    build_grid: float = 0.0
    sph_update: float = 0.0
    memcpy: float = 0.0
    iters: int = 0


def format_times(times: Times) -> str:
    """displayTimes' iomanip layout (times.h:12-36): fixed 5 decimals."""
    avg_bg = times.build_grid / times.iters if times.iters else 0.0
    avg_su = times.sph_update / times.iters if times.iters else 0.0
    avg_mc = times.memcpy / times.iters if times.iters else 0.0
    lines = [
        f"{'Operation':<12}{'Per frame':>18}{'Total':>12}",
        "-" * 45,
        f"{'Grid construction':<11}{avg_bg:>11.5f}{times.build_grid:>15.5f}",
        f"{'SPH update':<12}{avg_su:>16.5f}{times.sph_update:>15.5f}",
        f"{'Data transfer':<12}{avg_mc:>15.5f}{times.memcpy:>15.5f}",
    ]
    return "\n".join(lines)


def display_times(times: Times) -> None:
    print(format_times(times))
