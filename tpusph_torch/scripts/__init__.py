"""Entry points of the rate probes, the counterparts of
`scripts/vpu_microbench.py` and `scripts/loop_probe.py`:

    python -m tpusph_torch.scripts.vpu_microbench
    python -m tpusph_torch.scripts.loop_probe [pt] [bl]

They time the card and need one; each probe rate is the slope over the
round count of the min-over-reps time of one call, from CUDA events
recorded around the launch.
"""

from __future__ import annotations

import functools
import os
import re
import shutil
import statistics
import subprocess

import torch


def cuda_device() -> torch.device:
    """The card the probes time; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time a GPU: torch.cuda is not available")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_card(device) -> str:
    """`card_line()` for a card, `cpu` for the CPU: what a result records
    as the device it ran on."""
    return card_line() if torch.device(device).type == "cuda" else "cpu"


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


def graph_ms(fn, calls: int = 10, reps: int = 11) -> float:
    """Device ms of one call of `fn`: `calls` calls captured in one CUDA
    graph (after a warm-up on a side stream), the median over `reps`
    replays timed by CUDA events, over `calls`. No host time between the
    launches, unlike `timed`; `fn` must be capturable (no host sync)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


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


@functools.cache
def _sass(library: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def sass_loops(library, *name_parts: str, load: str = "LDG") -> list[tuple[int, int]]:
    """(instructions, loads) of each loop of one kernel in a built library:
    `cuobjdump -sass` of `library`, the function whose mangled name holds
    every one of `name_parts`, and in it each backward branch with the
    instructions from its target up to it, those of opcode `load` (LDG from
    device memory, LDS from shared memory) among them counted. Raises if
    `cuobjdump` or the kernel is not found."""
    sass = _sass(str(library))
    found = [body for head, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)",
                                               sass, flags=re.S)
             if all(part in head for part in name_parts)]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} kernels in {library} match {name_parts}")
    # an instruction line: /*address*/ text ; (its second line holds bits only)
    code = [(int(addr, 16), text) for addr, text in
            re.findall(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", found[0], flags=re.M)]
    loops = []
    for addr, text in code:
        branch = re.search(r"\bBRA\S*\s+(?:\S+,\s*)?`?\(?(0x[0-9a-f]+)", text)
        if branch and int(branch.group(1), 16) <= addr:
            body = [t for a, t in code if int(branch.group(1), 16) <= a <= addr]
            loops.append((len(body), sum(load in t for t in body)))
    return loops
