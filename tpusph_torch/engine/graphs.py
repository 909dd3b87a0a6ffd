"""CUDA graphs, the counterpart of the JAX package's jitted dispatches:
its `jax.jit` steps, timed phases and `lax.scan` chains each run here as
one replay of a graph captured at the first call.

`capture(body, device)` runs `body()` once eagerly on a side stream (the
warm-up: it makes every per-(cfg, device) constant and lets the caching
allocator see the shapes), then records a second call into a
`torch.cuda.CUDAGraph` under the capture guard (`no_host_reads`). Nothing
in `body` may read the host or copy from it; the step code keeps its
constants on the device for that. A capture that fails raises: there is
no eager fallback.

The capture guard: while a body is captured on a card, or run as that
body on the CPU, any read of the host (`.item`, `.tolist`, `.cpu`,
`.numpy`, `bool` / `int` / `float` / index of a tensor) raises
`HostReadError` (a `TorchFunctionMode`, on both devices), except inside a
kernel's plain version, which stands for a launch
(`kernels/launch.py::plain_version`); on a card
`torch.cuda.set_sync_debug_mode("error")` also holds around capture and
replay, so a synchronising call raises too.

A branch on the device: `torch.cond` becomes a conditional node of the
graph where torch has the dispatch mode that captures it
(`CONDITIONAL_NODES`); a body chooses by that flag, never by catching a
failure.

The kernel wrappers count launches in Python, so a replay would count
nothing. `CapturedGraph` keeps the per-replay launch counts of each
counted wrapper, taken at capture, and adds them to the wrappers'
`.launches` on every replay; the launches recorded during capture, which
did not run, are taken back (the warm-up's ran, and count). The counts
stay the number of launches the card ran.

`GraphedLoop` is what the entry points use: a function of a list of
tensors, run under the guard on the CPU and as a replay on a card. Its
`after=` form reads another loop's inputs and outputs where that loop's
last call left them, so a timed step's two phases are two replays with no
copy between them. `captures` counts the graphs made (on the CPU, the
first guarded call of each loop), so a caller can see a re-capture.
"""

from __future__ import annotations

import contextlib
import importlib.util

import torch
from torch.overrides import TorchFunctionMode

from tpusph_torch.kernels.fused import density, force
from tpusph_torch.kernels.launch import in_plain_version
from tpusph_torch.kernels.qrank import rank_queries

COUNTED = (rank_queries, density, force)

# torch.cond under stream capture becomes a conditional node through this
# module's dispatch modes (not in torch 2.11; in 2.13)
CONDITIONAL_NODES = (
    importlib.util.find_spec("torch._higher_order_ops.cudagraph_conditional_nodes") is not None
)

captures = 0  # graphs made in this process (on the CPU: first guarded calls)

_READS = {
    torch.Tensor.item: ".item()",
    torch.Tensor.tolist: ".tolist()",
    torch.Tensor.cpu: ".cpu()",
    torch.Tensor.numpy: ".numpy()",
    torch.Tensor.__bool__: "bool()",
    torch.Tensor.__int__: "int()",
    torch.Tensor.__float__: "float()",
    torch.Tensor.__index__: "an index",
}


class HostReadError(RuntimeError):
    """A graphed body read a tensor on the host."""


class _NoHostReads(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _READS and not in_plain_version():
            raise HostReadError(f"{_READS[func]} of a tensor inside a graphed body")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_reads(device: torch.device):
    """The capture guard: a host read of a tensor raises `HostReadError`;
    on a card a synchronising call raises too (sync debug mode "error")."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with _NoHostReads():
            yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(previous)


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


def _control_flow_modes():
    """(warm-up mode, capture mode) that make `torch.cond` capturable where
    torch has them; null contexts otherwise."""
    if not CONDITIONAL_NODES:
        return contextlib.nullcontext(), contextlib.nullcontext()
    from torch._higher_order_ops import cudagraph_conditional_nodes as cn

    return cn.ControlFlowOpWarmupDispatchMode(), cn.CUDAGraphCaptureControlFlowOpDispatchMode()


def capture(body, device: torch.device):
    """(CapturedGraph, outputs of `body()` in the graph's memory): a warm-up
    call of `body` on a side stream, then its capture under the capture
    guard. Raises if capture fails; there is no eager fallback."""
    global captures
    from tpusph_torch.utils import cuda_build

    cuda_build.library()  # nvcc and the ctypes load never run inside capture
    warm_mode, capture_mode = _control_flow_modes()
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(compute)
    with torch.cuda.stream(side), warm_mode:
        body()
    compute.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph), capture_mode, no_host_reads(device):
        outputs = body()
    per_replay = {fn: n - before[fn] for fn, n in launch_counts().items()}
    for fn, n in per_replay.items():
        fn.launches -= n  # recorded, not run
    captures += 1
    return CapturedGraph(graph, per_replay), outputs


class GraphedLoop:
    """`fn(list of tensors) -> list` on `device`: one CUDA-graph replay on a
    card, `fn` under the capture guard on the CPU.

    On a card the first call captures `fn` on copies of its inputs; each
    call copies its inputs into the graph's input tensors (skipping a
    tensor that is the graph's own), replays, and returns the outputs:
    clones, so a later replay never touches what an earlier call handed
    out, or with `clone=False` the graph's own tensors, valid until the
    next call. An output that is not a tensor is a constant of the body and
    comes back as the capture saw it.

    `after`: a loop whose input and output tensors this one reads, where
    that loop's last call left them; call it with no inputs, after that
    loop. `inputs` / `outputs`: the graph's tensors on a card, the last
    call's on the CPU."""

    def __init__(self, fn, device, clone: bool = True, after: GraphedLoop | None = None):
        self.fn = fn
        self.device = torch.device(device)
        self.clone = clone
        self.after = after
        self.graph: CapturedGraph | None = None
        self.inputs: list | None = None
        self.outputs: list | None = None

    def __call__(self, inputs: list | None = None) -> list:
        global captures
        if self.after is not None:
            inputs = [*self.after.inputs, *self.after.outputs]
        if self.device.type != "cuda":
            if self.outputs is None:
                captures += 1
            with no_host_reads(self.device):
                self.outputs = self.fn(list(inputs))
            self.inputs = inputs
            return self.outputs
        if self.graph is None:
            self.inputs = (list(inputs) if self.after is not None
                           else [t.to(self.device, copy=True, non_blocking=True) for t in inputs])
            self.graph, self.outputs = capture(lambda: self.fn(self.inputs), self.device)
        elif self.after is None:
            for dst, src in zip(self.inputs, inputs):
                if dst is not src:
                    dst.copy_(src, non_blocking=True)
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            self.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(previous)
        if not self.clone:
            return list(self.outputs)
        return [t.clone() if torch.is_tensor(t) else t for t in self.outputs]
