"""The condition of a branch inside a captured CUDA graph: the counterpart
of the predicate of `lax.cond` in `tpusph/dist/sharded.py:578-612`.

The CUDA side is `tpusph_torch/csrc/graph_cond.cu`. `tpusph_graph_if`
adds two nodes to the graph that the current stream captures: the
one-thread kernel `set_if`, which sets a conditional handle to `pred > 0`
on the device, and behind it an "if" node whose body is a copy of a graph
captured beforehand. `set_if(pred, body)` is its wrapper: on a CUDA tensor
it makes that addition (the stream must be capturing) and counts one
launch; on a CPU tensor it takes the plain version, `set_if_plain`. Both
return the condition, `pred > 0`, as a bool tensor on `pred`'s device, for
the select that follows the node (`engine/graphs.py::device_if`).
`node_counts(graph)` counts the nodes of a captured graph by type,
`node_total(graph)` only their number.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusph_torch.kernels.launch import check_tensor, on_cpu, plain_version, stream_of

NODE_TYPES = ("nodes", "kernel", "memcpy", "memset", "child graph", "conditional", "other")
# libcuda's CUgraphNodeType values (cuda.h) of the types counted
CU_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "child graph", 13: "conditional"}


def set_if_plain(pred: torch.Tensor) -> torch.Tensor:
    """The condition `set_if` sets: pred > 0."""
    return pred > 0


def set_if(pred: torch.Tensor, body: int | None = None) -> torch.Tensor:
    """The condition pred > 0 (bool, 0-d) of an int32 0-d `pred`. On a card
    the current stream must be capturing: `set_if` is launched on it and an
    "if" node follows whose body is a copy of the graph `body` (a
    `cudaGraph_t` as an int); the node runs the body at each replay where
    pred > 0 holds then. Raises where the library or the capture refuses."""
    dev = pred.device
    check_tensor("pred", pred, torch.int32, dev, shape=())
    if on_cpu(dev):
        with plain_version():
            return set_if_plain(pred)
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("set_if adds a node to a captured graph: the stream is not capturing")
    from tpusph_torch.utils import cuda_build

    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.tpusph_graph_if(stream_of(dev), pred.data_ptr(), body)
    cuda_build.check(err, "set_if")
    set_if.launches += 1
    return pred > 0


set_if.launches = 0


@functools.cache
def _libcuda() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return cu


def _check_cu(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: libcuda error {err}")


def node_total(graph: int) -> int:
    """The number of top-level nodes of `graph` (a `cudaGraph_t` as an
    int): one `cuGraphGetNodes` with no array."""
    n = ctypes.c_size_t(0)
    _check_cu(_libcuda().cuGraphGetNodes(graph, None, ctypes.addressof(n)), "cuGraphGetNodes")
    return n.value


def node_counts(graph: int) -> dict:
    """{type: count} of the top-level nodes of `graph` (a `cudaGraph_t`
    as an int), "nodes" the total (`NODE_TYPES`). Read through libcuda
    (`cuGraphGetNodes`, `cuGraphNodeGetType`), which both runtimes share:
    the runtime linked into the kernel library fails (error 999) on the
    type of a conditional node in a graph that torch's runtime captured
    (H100, torch 2.11.0+cu128, nvcc 12.9)."""
    cu = _libcuda()
    n = ctypes.c_size_t(node_total(graph))
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        _check_cu(cu.cuGraphGetNodes(graph, ctypes.addressof(nodes), ctypes.addressof(n)),
                  "cuGraphGetNodes")
    counts = dict.fromkeys(NODE_TYPES, 0)
    counts["nodes"] = n.value
    kind = ctypes.c_int(-1)
    for node in nodes[:n.value]:
        _check_cu(cu.cuGraphNodeGetType(node, ctypes.addressof(kind)), "cuGraphNodeGetType")
        counts[CU_NODE_TYPES.get(kind.value, "other")] += 1
    return counts
