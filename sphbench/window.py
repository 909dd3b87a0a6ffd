"""What a loop records in the window, and its clocks.

Every loop (`loops/<loop>.py`) adds its whole runs to one `Record`; the
metric readers read it. `Marks` times intervals on the device's clock.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tpusph_torch.bench.times import Times


@dataclasses.dataclass
class Record:
    """What a window measured: whole runs only."""

    runs: int = 0
    failed: int = 0
    steps: int = 0
    run_s: list = dataclasses.field(default_factory=list)  # seconds a run
    step_s: list = dataclasses.field(default_factory=list)  # seconds a timed step
    window_s: float = 0.0
    times: Times = dataclasses.field(default_factory=Times)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Pairs of time marks for `count` intervals: CUDA events on the
    current stream on a card (the device's clock, which resolves what the
    host's clock cannot), the host's clock on the CPU, where only tests
    run. `seconds()` is read once the device has passed every mark."""

    def __init__(self, device: torch.device, count: int):
        self.cuda = device.type == "cuda"
        self.marks = [[_mark(self.cuda) for _ in range(2)] for _ in range(count)]

    def start(self, k: int) -> None:
        _record(self.marks[k][0], self.cuda)

    def end(self, k: int) -> None:
        _record(self.marks[k][1], self.cuda)

    def seconds(self, count: int) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in self.marks[:count]]
        return [b[0] - a[0] for a, b in self.marks[:count]]


def _mark(cuda: bool):
    return torch.cuda.Event(enable_timing=True) if cuda else [0.0]


def _record(mark, cuda: bool) -> None:
    if cuda:
        mark.record()
    else:
        mark[0] = time.perf_counter()
