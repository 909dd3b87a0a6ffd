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

A branch on the device, tpusph's `lax.cond`: `device_if(pred, branch,
args, out)` is `branch(*args)` where the 0-d `pred` is true (above 0),
else `out`. On a card the warm-up call of a body captures `branch` once
into a graph of its own (a private memory pool, static input and output
tensors) and replays it; the capture call copies `args` into the
branch's inputs and adds a conditional node behind the port's own kernel
`set_if` (`kernels/graph_cond.py`, `csrc/graph_cond.cu`), whose body is a
copy of the branch's graph, then selects between the branch's output and
`out` by `pred`. Each replay runs the branch only where `pred` holds
then. On the CPU both are computed and selected by `pred`, the same rows.
The same on every torch; nothing falls back: a library that does not
build, a node that does not instantiate or a torch without `keep_graph`
raises. Every graph keeps its `cudaGraph_t` (`keep_graph=True`,
instantiated after its capture), so its nodes can be counted
(`graph_cond.node_counts`).

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
copy between them. `captures` counts the loops captured (on the CPU, the
first guarded call of each loop), so a caller can see a re-capture.

`CarriedLoop` is the timed step's: its two phases keep the state in the
graphs' own tensors from step to step, in two buffers, S0 and S1, each read
by one pair of (build, update) loops and written by the other's update. A
step from the state the previous step left copies nothing in and clones
nothing out; any other state is copied into S0 once.

Spans (`bench/spans.py`), while a profile records: `graph.call` around a
`GraphedLoop` call, and inside it `graph.copy_in` (the inputs' copies into
the graph's tensors: a carried loop's state other than its buffers),
`graph.replay` (each `CUDAGraph.replay()`, the host's launch; on the CPU
the body's guarded call) and `graph.clone_out` (the output clones); the
counter `graph.nodes` adds each replayed graph's top-level nodes, counted
at capture, and `graph.carried` each carried step. Every capture records
`graph.warmup` (the warm-up call) and `graph.record` (capture and
instantiation), profile or not.

`SegmentedLoop` is a `GraphedLoop` whose body talks to other ranks: a
sharded step of a rank with peers. A transport between ranks (a gloo
exchange is a copy to the host, a send and a receive, a copy back) cannot
sit in a graph, so the body is captured as a chain of graphs, one segment
between two transports. A communicator hands each transport to `cross`;
inside a segmented body that call is a boundary: the open segment ends,
the transport is recorded with the tensors it was handed (static send
tensors, the graph's own), and the body gets static receive tensors of
the shapes the call promises, which each replay fills. A replay runs
segment, transport, segment, ... in capture order: the segments share one
memory pool, and a tensor that crosses a boundary as a local of the body
keeps its address. A segment begins at the body's first tensor operation
after a boundary, so a body that ends at a transport has no empty segment
behind it. On the CPU the same body runs under the guard, its transports
let through, and the boundaries are counted the same way (`structure`).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.overrides import TorchFunctionMode

from tpusph_torch.bench.spans import count, span
from tpusph_torch.kernels.fused import density, force, force_pack
from tpusph_torch.kernels.graph_cond import node_total, set_if
from tpusph_torch.kernels.launch import in_plain_version, on_cpu
from tpusph_torch.kernels.qrank import rank_queries

COUNTED = (rank_queries, density, force_pack, force, set_if)

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


_segmenting = None  # the SegmentedLoop whose body runs now (its capture; every CPU call)
_crossing = 0  # transports running inside a segmented body now (on the CPU)


class _NoHostReads(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not _crossing:
            if func in _READS and not in_plain_version():
                raise HostReadError(f"{_READS[func]} of a tensor inside a graphed body")
            if _segmenting is not None and _segmenting._pending:
                _segmenting._begin()
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _sync_debug(mode):
    """torch.cuda's sync debug mode `mode` inside the block ("error": a
    synchronising call raises)."""
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def no_host_reads(device: torch.device):
    """The capture guard: a host read of a tensor raises `HostReadError`;
    on a card a synchronising call raises too (sync debug mode "error")."""
    cuda = torch.device(device).type == "cuda"
    with _sync_debug("error") if cuda else contextlib.nullcontext(), _NoHostReads():
        yield


def launch_counts() -> dict:
    """{wrapper: .launches} of the step kernels' wrappers."""
    return {fn: fn.launches for fn in COUNTED}


class CapturedGraph:
    """A captured graph, the launches of each counted wrapper that one
    replay makes, and its top-level nodes (`graph_cond.node_total`, 0 where
    not counted). `graph` needs only a `replay()` method."""

    def __init__(self, graph, launches: dict, nodes: int = 0):
        self.graph = graph
        self.launches = {fn: n for fn, n in launches.items() if n}
        self.nodes = nodes

    def replay(self) -> None:
        with span("graph.replay"):
            self.graph.replay()
        count("graph.nodes", self.nodes)
        for fn, n in self.launches.items():
            fn.launches += n


def _nodes(graph) -> int:
    """The top-level nodes of an instantiated `torch.cuda.CUDAGraph` made
    with `keep_graph=True`."""
    return node_total(graph.raw_cuda_graph())


_warming = 0  # warm-up calls of a body on a card running now


@contextlib.contextmanager
def _warm_up():
    """Around the warm-up call of a body that is captured next."""
    global _warming
    _warming += 1
    try:
        yield
    finally:
        _warming -= 1


class _BranchGraph:
    """`branch` captured into a graph of its own on static copies of its
    arguments, after one eager call on them: the body of a conditional
    node. Its memory pool is private, so that no tensor of a graph that
    holds the node is ever handed to the branch's temporaries."""

    def __init__(self, branch, args, device):
        self.inputs = [a.clone() for a in args]
        branch(*self.inputs)  # the eager call: lazy state is made outside the capture
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            try:
                with no_host_reads(device):
                    self.output = branch(*self.inputs)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph.instantiate()
        if not torch.is_tensor(self.output):
            raise TypeError("a branch of device_if returns one tensor")


_branch_graphs: dict = {}  # (branch, device, argument shapes and dtypes) -> _BranchGraph


def device_if(pred: torch.Tensor, branch, args, out: torch.Tensor) -> torch.Tensor:
    """`branch(*args)` where the 0-d `pred` (bool, or int) is above 0, else
    `out` (a tensor shaped as the branch's output), inside a graphed body
    (module docstring): a conditional node on a card, the two selected by
    `pred` on the CPU. On a card it raises outside the warm-up and the
    capture of a body."""
    flag = pred.to(torch.int32)
    device = flag.device
    if on_cpu(device):
        return torch.where(set_if(flag), branch(*args), out)
    capturing = torch.cuda.is_current_stream_capturing()
    if not (capturing or _warming):
        raise RuntimeError("device_if runs inside a graphed body (its warm-up or capture)")
    key = (branch, device, tuple((tuple(a.shape), a.dtype) for a in args))
    if key not in _branch_graphs:
        if capturing:
            raise RuntimeError("device_if: the branch is captured at the body's warm-up call")
        _branch_graphs[key] = _BranchGraph(branch, args, device)
    taken = _branch_graphs[key]
    for dst, src in zip(taken.inputs, args):
        dst.copy_(src)
    if capturing:
        cond = set_if(flag, taken.graph.raw_cuda_graph())
    else:  # the warm-up: the branch runs, the select picks
        taken.graph.replay()
        cond = flag > 0
    return torch.where(cond, taken.output, out)


def capture(body, device: torch.device):
    """(CapturedGraph, outputs of `body()` in the graph's memory): a warm-up
    call of `body` on a side stream, then its capture under the capture
    guard. Raises if capture fails; there is no eager fallback."""
    global captures
    from tpusph_torch.utils import cuda_build

    cuda_build.library()  # nvcc and the ctypes load never run inside capture
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(compute)
    with span("graph.warmup", always=True), torch.cuda.stream(side), _warm_up():
        body()
    compute.wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = launch_counts()
    with span("graph.record", always=True):
        with torch.cuda.graph(graph), no_host_reads(device):
            outputs = body()
        graph.instantiate()
    per_replay = {fn: n - before[fn] for fn, n in launch_counts().items()}
    for fn, n in per_replay.items():
        fn.launches -= n  # recorded, not run
    captures += 1
    return CapturedGraph(graph, per_replay, _nodes(graph)), outputs


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
    loop. `inputs` given: the graph's input tensors are these, the
    caller's, on both devices; a call copies into them what it is handed
    (before the capture's warm-up, which reads them), and nothing where it
    is handed None or this very list; the body must not write them.
    `inputs` / `outputs`: the graph's tensors on a card, the last call's
    on the CPU."""

    def __init__(self, fn, device, clone: bool = True, after: GraphedLoop | None = None,
                 inputs: list | None = None):
        self.fn = fn
        self.device = torch.device(device)
        self.clone = clone
        self.after = after
        self.static = inputs is not None
        self.graph: CapturedGraph | None = None
        self.inputs: list | None = inputs
        self.outputs: list | None = None

    def __call__(self, inputs: list | None = None) -> list:
        global captures
        with span("graph.call"):
            if self.after is not None:
                inputs = [*self.after.inputs, *self.after.outputs]
            elif self.static:  # its body reads them before the capture's warm-up
                self._copy_in(inputs)
                inputs = self.inputs
            if self.device.type != "cuda":
                if self.outputs is None:
                    captures += 1
                self.inputs = inputs
                with span("graph.replay"):  # the body's guarded call stands for it
                    self.outputs = self._run(list(inputs))
                return self.outputs
            if not self._captured():
                if not self.static:
                    self.inputs = (list(inputs) if self.after is not None else
                                   [t.to(self.device, copy=True, non_blocking=True)
                                    for t in inputs])
                self._capture()
            if self.after is None:  # the warm-up of a body that writes its inputs wrote them
                self._copy_in(inputs)
            self._replay()
            if not self.clone:
                return list(self.outputs)
            with span("graph.clone_out"):
                return [t.clone() if torch.is_tensor(t) else t for t in self.outputs]

    def _copy_in(self, inputs: list | None) -> None:
        """Copy `inputs` into the graph's input tensors, each but those that
        are the graph's own; nothing where `inputs` is None or the graph's
        own list."""
        if inputs is None or inputs is self.inputs:
            return
        with span("graph.copy_in"):
            for dst, src in zip(self.inputs, inputs):
                if dst is not src:
                    dst.copy_(src, non_blocking=True)

    def _run(self, inputs: list) -> list:
        with no_host_reads(self.device):
            return self.fn(inputs)

    def _captured(self) -> bool:
        return self.graph is not None

    def _capture(self) -> None:
        self.graph, self.outputs = capture(lambda: self.fn(self.inputs), self.device)

    def _replay(self) -> None:
        with _sync_debug("error"):
            self.graph.replay()


class CarriedLoop:
    """A step of two phases whose state stays in the graphs' own tensors from
    one step to the next: `build(state)` then `update()`, where
    `build_fn(state) -> list` and `update_fn(state + build's outputs, out)
    -> [*state', *rest]`. `update_fn` writes the new state into the tensors
    `out` and returns them, and returns a field it leaves as it came as
    that input tensor; with `out=None` it makes fresh tensors (the eager
    body). `fields`: the length of the state list.

    With `carry` (the default on a card) there are two state buffers and
    two pairs of (build, update) `GraphedLoop`s, nothing cloned: S0, made
    at the first call, and S1, the tensors pair A's update returns. Pair
    A's build reads S0 and its update writes S1; pair B's reads S1 and
    writes S0. A step whose state is a buffer by the identity of every
    tensor runs that buffer's pair and enqueues no copy or clone (the
    counter `graph.carried`); any other state is copied into S0 (the span
    `graph.copy_in`, inside pair A's build) and runs pair A. A pair is
    captured at its first step. So the state `update()` returns is a
    buffer: it holds until the next step, which may copy into S0. Without
    `carry` (the CPU), one pair of plain loops, as `GraphedLoop`'s
    `after=` form makes them: the bodies run eagerly and return fresh
    tensors, nothing copied."""

    def __init__(self, build_fn, update_fn, device, fields: int):
        self.build_fn, self.update_fn, self.fields = build_fn, update_fn, fields
        self.device = torch.device(device)
        self.carry = self.device.type == "cuda"
        self.buffers: list = []  # S0, then S1
        self.pairs: list = []  # (build, update) loops: pair A reads S0, pair B S1
        self._pair: tuple | None = None  # the pair of the step under way

    def source(self, state: list) -> int | None:
        """The buffer that `state` is, tensor for tensor, else None."""
        for k, buf in enumerate(self.buffers):
            if all(a is b for a, b in zip(state, buf)):
                return k
        return None

    def build(self, state: list) -> list:
        """Replay the build of the pair that reads `state` (module docstring)."""
        if not self.carry:
            if not self.pairs:
                build = GraphedLoop(self.build_fn, self.device, clone=False)
                self.pairs.append((build, GraphedLoop(self.update_fn, self.device, after=build)))
            self._pair = self.pairs[0]
            return self._pair[0](state)
        k = self.source(state)
        if k is None:
            if not self.buffers:
                self.buffers.append([torch.empty_like(t, device=self.device) for t in state])
            k = 0
        else:
            count("graph.carried", 1)
            state = None  # the build reads its own tensors
        if k == len(self.pairs):
            out = ([torch.empty_like(t) for t in self.buffers[0]] if k == 0
                   else self.buffers[0])
            build = GraphedLoop(self.build_fn, self.device, clone=False, inputs=self.buffers[k])
            update = GraphedLoop(functools.partial(self.update_fn, out=out), self.device,
                                 clone=False, after=build)
            self.pairs.append((build, update))
        self._pair = self.pairs[k]
        return self._pair[0](state)

    def update(self) -> list:
        """Replay the update of the step's pair: [*state', *rest]."""
        outputs = self._pair[1]()
        if self.carry and len(self.buffers) == 1:  # pair A's first step made S1
            self.buffers.append(outputs[: self.fields])
        return outputs


def cross(kind: str, transport, args, like):
    """`transport(*args)`: a communicator's move of data between ranks
    (`kind` "exchange", "reduce" or "gather"). Inside a segmented body it is
    a boundary of that loop (module docstring); `like` holds tensors shaped
    as what `transport` returns, in its nesting of lists."""
    if _segmenting is None:
        return transport(*args)
    return _segmenting._boundary(kind, transport, args, like)


def _leaves(tree) -> list:
    """The tensors of nested lists and tuples, depth first."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _empty_like(tree):
    """Fresh tensors shaped as the leaves of `tree`, in its nesting (lists)."""
    if isinstance(tree, (list, tuple)):
        return [_empty_like(sub) for sub in tree]
    return torch.empty_like(tree)


class _Transport:
    """A boundary of a captured body: `fn(*args)` on its static send
    tensors, what it returns copied into the static receive tensors."""

    def __init__(self, fn, args, receives):
        self.fn, self.args, self.receives = fn, args, receives

    def run(self) -> None:
        for dst, src in zip(_leaves(self.receives), _leaves(self.fn(*self.args))):
            dst.copy_(src, non_blocking=True)


class SegmentedLoop(GraphedLoop):
    """A `GraphedLoop` whose body may move data between ranks (`cross`):
    on a card a chain of CUDA graphs split at each transport (module
    docstring), captured at the first call after a warm-up call with the
    real transports, and replayed segment, transport, segment, ...; sync
    debug mode "error" holds around each segment's replay and not around a
    transport (gloo copies to the host by design). On the CPU the body runs
    under the guard, its transports let through. A body with no transport
    is one graph. There is no eager fallback: a capture that fails raises.

    `structure`: the chain as the first call found it, "segment",
    "exchange", "reduce" or "gather" in order, on both devices. `launches`:
    each segment's launches a replay (a card's)."""

    def __init__(self, fn, device, clone: bool = True, after: GraphedLoop | None = None):
        super().__init__(fn, device, clone, after)
        self.chain: list | None = None  # CapturedGraph and _Transport, in replay order
        self.structure: list | None = None
        self._recording = self._pending = False
        self._open = None  # (graph, launch counts at its begin) of the segment being captured
        self._pool = None

    @property
    def launches(self) -> list:
        return [item.launches for item in self.chain if isinstance(item, CapturedGraph)]

    def _captured(self) -> bool:
        return self.chain is not None

    def _run(self, inputs: list) -> list:
        return self._segmented(inputs, recording=self.structure is None)

    def _segmented(self, inputs: list, recording: bool) -> list:
        """`fn(inputs)` under the guard with this loop's boundaries."""
        global _segmenting
        if recording:
            self.structure = []
        self._recording, self._pending = recording, True
        _segmenting = self
        try:
            with no_host_reads(self.device):
                out = self.fn(inputs)
                self._end()
            return out
        finally:
            _segmenting = None
            if self._open is not None:  # the body failed inside a segment
                graph, self._open = self._open[0], None
                with contextlib.suppress(Exception):
                    graph.capture_end()

    def _capture(self) -> None:
        global captures
        from tpusph_torch.utils import cuda_build

        cuda_build.library()  # nvcc and the ctypes load never run inside capture
        compute = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            with span("graph.warmup", always=True), _warm_up():
                self.fn(self.inputs)
            self.chain, self._pool = [], torch.cuda.graph_pool_handle()
            try:
                with span("graph.record", always=True):
                    self.outputs = self._segmented(self.inputs, recording=True)
            except BaseException:
                self.chain = None
                raise
        for item in self.chain:
            if isinstance(item, CapturedGraph):
                item.nodes = _nodes(item.graph)
        compute.wait_stream(side)
        captures += 1

    def _begin(self) -> None:
        """Open a segment: on a card begin its capture into the loop's pool."""
        self._pending = False
        if self._recording:
            self.structure.append("segment")
        if self.device.type == "cuda":
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = launch_counts()
            with _sync_debug("default"):  # the guard is for the body, not the capture's calls
                graph.capture_begin(pool=self._pool)
            self._open = (graph, before)

    def _end(self) -> None:
        """Close the open segment's capture, if any, and chain it."""
        if self._open is None:
            return
        (graph, before), self._open = self._open, None
        with _sync_debug("default"):
            graph.capture_end()
            graph.instantiate()
        per_replay = {fn: n - before[fn] for fn, n in launch_counts().items()}
        for fn, n in per_replay.items():
            fn.launches -= n  # recorded, not run
        self.chain.append(CapturedGraph(graph, per_replay))

    def _boundary(self, kind: str, transport, args, like):
        global _crossing
        _crossing += 1
        try:
            if self.device.type == "cuda":
                self._end()
                got = _empty_like(like)
                self.chain.append(_Transport(transport, args, got))
            else:
                got = transport(*args)
        finally:
            _crossing -= 1
        if self._recording:
            self.structure.append(kind)
        self._pending = True
        return got

    def _replay(self) -> None:
        for item in self.chain:
            if isinstance(item, CapturedGraph):
                with _sync_debug("error"):
                    item.replay()
            else:
                item.run()
