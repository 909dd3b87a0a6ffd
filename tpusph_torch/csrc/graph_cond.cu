// A branch on the device inside a CUDA graph: an "if" conditional node.
//
// Replaces the lax.cond of tpusph/dist/sharded.py:578-612 (`n_dn + n_up > 0`
// picks `_mig_sort` over `_mig_skip`). Under jit that cond runs one branch on
// the TPU; a captured CUDA graph has no branch of its own, so the port adds a
// conditional node to the graph being captured: a one-thread kernel, set_if,
// reads the predicate on the device and sets the node's condition, and the
// node runs its body (a copy of a graph captured beforehand, the branch) only
// where that condition is non-zero. Nothing is read on the host.
//
// What bounds set_if on the H100: neither bytes nor operations (4 bytes read,
// one compare); it costs a launch inside the graph, and the node an
// evaluation of its condition. The design keeps it to one thread in one block
// and one node a branch.
//
// tpusph_graph_if is called while `stream` captures (engine/graphs.py,
// device_if): the handle is made on the capturing graph, set_if is launched
// on the stream so that the capture records it, and the conditional node is
// added by hand behind it and made the stream's dependency, so that the
// capture's next operation follows the node. The body is a child-graph node
// holding a copy of `child`. A body may hold only kernel, memset, memcpy,
// empty, child-graph and conditional nodes; anything else fails the
// instantiation of the enclosing graph, which the caller reports.
//
// The library links its own CUDA runtime (static) while PyTorch uses another;
// streams, graphs and handles are objects of libcuda, the same under both.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const int32_t* pred) {
  cudaGraphSetConditional(handle, *pred > 0 ? 1u : 0u);
}

}  // namespace

// Adds to the graph that `stream` captures: set_if on pred[0] (int32 on the
// device), then an if node whose body is a copy of `child`. Returns the first
// CUDA error, else cudaGetLastError().
extern "C" int tpusph_graph_if(cudaStream_t stream, const int32_t* pred, cudaGraph_t child) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);

  // the condition is 0 at each launch of the graph until set_if sets it
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the stream's dependencies are now set_if's node
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  cudaGraphNode_t child_node;
  err = cudaGraphAddChildGraphNode(&child_node, body, nullptr, 0, child);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
