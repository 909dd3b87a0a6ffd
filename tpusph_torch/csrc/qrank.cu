// Rank of query values among sorted cell keys:
//   ranks[i] = #{j : key_sorted[j] < queries[i]}   (== starts[queries[i]]).
//
// Replaces tpusph/pallas/qrank.py: rank_queries_pallas / _rank_sorted_chunks
// / _qrank_kernel. The TPU kernel sorts the queries, cuts them into chunks
// and ranks each chunk by a mask-free outer compare against a window of
// keys, because gathers from a table are slow there. Here every query is a
// lower-bound binary search by one thread, which a GPU does well: the keys
// (1 MB at 262,144 particles) stay in L2, and neighbouring queries walk
// nearly the same path, so the loads of a warp hit the same lines.
//
// What bounds it on the H100: about log2(n) = 18 dependent L2 loads per
// query; the step asks 1,000,002 queries (every cell of the 100³ grid plus
// the two sentinel entries), so the kernel is latency bound, and one
// thread per query gives the SMs enough warps to hide that latency.
//
// The TPU kernel's key window has a capacity (pallas_qrank_kcap) and
// reports an overflow count. A binary search over the whole array has no
// window, so there is no capacity and nothing can overflow; the wrapper
// returns an overflow of 0 for API parity.
//
// Queries above num_cells answer n: every key is <= num_cells (the
// sentinel of invalid slots), the same answer the TPU kernel gets by
// clamping them.

#include "common.cuh"

namespace tpusph {
namespace {

__global__ void __launch_bounds__(kBlock)
    qrank_kernel(const int* __restrict__ key_sorted, int n,
                 const int* __restrict__ queries, int nq, int num_cells,
                 int* __restrict__ ranks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int q = queries[i];
  if (q > num_cells) {
    ranks[i] = n;
    return;
  }
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(key_sorted + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  ranks[i] = lo;
}

}  // namespace
}  // namespace tpusph

extern "C" int tpusph_qrank(const int* key_sorted, int n, const int* queries,
                            int nq, int num_cells, int* ranks,
                            cudaStream_t stream) {
  if (nq > 0) {
    tpusph::qrank_kernel<<<tpusph::num_blocks(nq), tpusph::kBlock, 0, stream>>>(
        key_sorted, n, queries, nq, num_cells, ranks);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpusph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
