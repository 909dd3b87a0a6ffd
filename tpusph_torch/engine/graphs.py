"""CUDA graphs of chained steps, the counterpart of the JAX package's
`lax.scan` dispatches (bench.py's chained loop, `Simulator._chunk_fn`).

`capture(body, device)` runs `body()` once eagerly on a side stream (the
warm-up: it makes every per-(cfg, device) constant and lets the caching
allocator see the shapes), then records a second call into a
`torch.cuda.CUDAGraph`. Nothing in `body` may read the host or copy from
it; the step code keeps its constants on the device for that.

The kernel wrappers count launches in Python, so a replay would count
nothing. `CapturedGraph` keeps the per-replay launch counts of each
counted wrapper, taken at capture, and adds them to the wrappers'
`.launches` on every replay; the launches recorded during capture, which
did not run, are taken back. The counts stay the number of launches the
card ran.

`GraphedLoop` is what the chained loops use: a function of a list of
tensors, run eagerly on the CPU and as a replay on a card.
"""

from __future__ import annotations

import torch

from tpusph_torch.kernels.fused import density, force
from tpusph_torch.kernels.qrank import rank_queries

COUNTED = (rank_queries, density, force)


def launch_counts() -> dict:
    """{wrapper: .launches} of the step kernels' wrappers."""
    return {fn: fn.launches for fn in COUNTED}


class CapturedGraph:
    """A captured graph and the launches of each counted wrapper that one
    replay makes. `graph` needs only a `replay()` method."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = {fn: n for fn, n in launches.items() if n}

    def replay(self) -> None:
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n


def capture(body, device: torch.device):
    """(CapturedGraph, outputs of `body()` in the graph's memory): a warm-up
    call of `body` on a side stream, then its capture. Raises if capture
    fails; there is no eager fallback."""
    from tpusph_torch.utils import cuda_build

    cuda_build.library()  # nvcc and the ctypes load never run inside capture
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        body()
    compute.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        outputs = body()
    per_replay = {fn: n - before[fn] for fn, n in launch_counts().items()}
    for fn, n in per_replay.items():
        fn.launches -= n  # recorded, not run
    return CapturedGraph(graph, per_replay), outputs


class GraphedLoop:
    """`fn(list of tensors) -> list of tensors` on `device`. On the CPU each
    call runs `fn`. On a card the first call captures `fn` on copies of its
    inputs; each call copies its inputs into the graph's input tensors,
    replays, and returns clones of the outputs, so a later replay never
    touches what an earlier call handed out."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph: CapturedGraph | None = None
        self._inputs: list | None = None
        self._outputs: list | None = None

    def __call__(self, inputs: list) -> list:
        if self.device.type != "cuda":
            return self.fn(inputs)
        if self.graph is None:
            self._inputs = [t.to(self.device, copy=True) for t in inputs]
            self.graph, self._outputs = capture(lambda: self.fn(self._inputs), self.device)
        for dst, src in zip(self._inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        return [t.clone() for t in self._outputs]
