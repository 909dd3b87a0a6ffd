// Rank of query values among sorted cell keys:
//   ranks[i] = #{j : key_sorted[j] < queries[i]}   (== starts[queries[i]]).
//
// Replaces tpusph/pallas/qrank.py: rank_queries_pallas / _rank_sorted_chunks
// / _qrank_kernel. The TPU kernel rests on one fact: chunks of queries that
// are consecutive in value have key spans that partition the keys, so each
// chunk needs only a window of them. This kernel uses the same fact in the
// card's own form, a span staged in shared memory.
//
// What bounds it on the H100: bytes. A step asks 1,000,002 queries (every
// cell of the 100^3 grid plus two) of 262,144 keys: 1 MB of keys, 4 MB of
// queries and 4 MB of ranks, 9 MB a call, 0.0027 ms at 3.35 TB/s. One
// thread a query searching the whole array (the first design) spends its
// time elsewhere, on about log2(n) = 18 dependent loads from L2 for every
// query. What this design does about it:
//
//   * A block owns kRankQueries = 1,024 consecutive queries, four a thread,
//     read and written as one 16-byte vector (scalar loads for a ragged tail
//     and for query or rank pointers off 16 bytes).
//   * The block narrows once. It reduces its queries to (qmin, qmax) with
//     warp reductions, and two warps find lo = rank(qmin) and hi =
//     rank(qmax) cooperatively: the 32 lanes probe the last keys of 32 even
//     parts of the interval and a ballot picks the part, so 18 dependent
//     loads become 4 rounds of one load. The rank is monotone in the query,
//     so every answer of the block lies in [lo, hi]. A block in empty
//     space (2 % of the blocks of a step's queries at grid init, 44 % after
//     100 steps of the dam-break) finds hi == lo, the answer of all its
//     queries.
//   * A span of at most kRankStage = 4,096 keys (16 KB) is copied into
//     shared memory by 16-byte cp.async, from lo rounded down to hi rounded
//     up to 4 keys (4-byte copies where the keys do not start on 16 bytes or
//     n is not a multiple of 4), and every thread runs its four lower-bound
//     searches there, interleaved: at most 12 steps of shared-memory latency.
//     The widest span of a block at steps 0, 20 and 100 of the dam-break is
//     2,830 keys: every block of the main path stages or finds an empty span.
//   * A wider span (unsorted queries make every span the whole array) is
//     searched in device memory within [lo, hi], the thread's four searches
//     interleaved so that four loads are in flight. Sweeping such a span
//     through the stage in chunks instead moves the whole span through
//     every block and measured 2 to 4 times slower on unsorted queries.
//     On those this kernel and one thread a query wait for the same thing,
//     about 8 reads a query of scattered 32-byte sectors from L2 (the upper
//     levels of the search stay in L1), and this one has less L1 left
//     beside its stage: there it is the slower of the two (PERF.md).
//
// Every search takes the same number of steps for every thread of a block
// (the interval shrinks by a fixed rule whatever the compare says), so a
// warp never diverges in them.
//
// The TPU kernel's key window has a capacity (pallas_qrank_kcap) and
// reports an overflow count. Here a span that does not fit the stage is
// searched in place, so nothing can overflow; the wrapper returns an
// overflow of 0 for API parity.
//
// Queries above num_cells answer n: every key is <= num_cells (the
// sentinel of invalid slots), the same answer the TPU kernel gets by
// clamping them.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace tpusph {
namespace {

constexpr int kRankBlock = 256;                             // threads a block
constexpr int kRankPerThread = 4;                           // one int4 of queries
constexpr int kRankQueries = kRankBlock * kRankPerThread;   // queries a block
constexpr int kRankStage = 4096;                            // keys a block can stage
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ void stage_copy16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void stage_copy4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// #{j < n : keys[j] < q} by a whole warp. Each round cuts [a, b) into 32
// even parts; lane l reads the last key of part l (an empty part counts as
// not below q). The keys are sorted, so the parts wholly below q are lanes
// 0 .. m-1; the boundary lies in part m, whose last key is not below q.
__device__ __forceinline__ int warp_rank(const int* __restrict__ keys, int n, int q,
                                         int lane) {
  int a = 0;
  int b = n;
  while (b > a) {
    const int step = (b - a + 31) >> 5;
    const int first = a + lane * step;
    const int end = min(first + step, b);
    const bool below = first < b && __ldg(keys + end - 1) < q;
    const int m = __popc(__ballot_sync(kAllLanes, below));
    a = min(a + m * step, b);
    b = max(min(a + step, b) - 1, a);
  }
  return a;
}

// r[k] = #{j < len : keys[j] < q[k]}, the K searches step by step together.
// The interval of every search shrinks from len to len - len/2 whatever its
// compare says, so all threads of a block take the same steps.
template <int K>
__device__ __forceinline__ void lower_bounds(const int* __restrict__ keys, int len,
                                             const int (&q)[K], int (&r)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = 0;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] += keys[r[k] + half - 1] < q[k] ? half : 0;
    len -= half;
  }
  if (len == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] += keys[r[k]] < q[k] ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kRankBlock)
    qrank_block_kernel(const int* __restrict__ key_sorted, int n,
                       const int* __restrict__ queries, int nq, int num_cells,
                       bool quads_io, bool quads_keys, int* __restrict__ ranks) {
  __shared__ __align__(16) int stage[kRankStage + 8];
  __shared__ int warp_min[kRankBlock / 32];
  __shared__ int warp_max[kRankBlock / 32];
  __shared__ int span[2];
  static_assert(kRankBlock / 32 <= 32 && (32 % (kRankBlock / 32)) == 0,
                "one warp reduces the warps' extremes");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.x * kRankQueries + tid * kRankPerThread;
  const bool whole = quads_io && i0 + kRankPerThread <= nq;

  int q[kRankPerThread];
  if (whole) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(queries + i0));
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRankPerThread; ++k) q[k] = i0 + k < nq ? __ldg(queries + i0 + k) : 0;
  }

  // The block's smallest and largest query, and their ranks.
  int qmin = INT_MAX;
  int qmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kRankPerThread; ++k) {
    if (whole || i0 + k < nq) {
      qmin = min(qmin, q[k]);
      qmax = max(qmax, q[k]);
    }
  }
  qmin = __reduce_min_sync(kAllLanes, qmin);
  qmax = __reduce_max_sync(kAllLanes, qmax);
  if (lane == 0) {
    warp_min[warp] = qmin;
    warp_max[warp] = qmax;
  }
  __syncthreads();
  if (warp < 2) {  // warp 0 ranks qmin, warp 1 qmax
    const int w = lane % (kRankBlock / 32);
    const int v = warp == 0 ? __reduce_min_sync(kAllLanes, warp_min[w])
                            : __reduce_max_sync(kAllLanes, warp_max[w]);
    const int r = warp_rank(key_sorted, n, v, lane);
    if (lane == 0) span[warp] = r;
  }
  __syncthreads();
  const int lo = span[0];
  const int hi = span[1];
  const int width = hi - lo;

  int r[kRankPerThread] = {};  // ranks within the span; an empty span leaves 0
  if (width > kRankStage) {
    lower_bounds(key_sorted + lo, width, q, r);
  } else if (width > 0) {
    int first = lo;  // the key that stage[0] holds
    if (quads_keys) {
      first = lo & ~3;
      const int quads = (hi - first + 3) >> 2;  // n % 4 == 0: never past the keys
      for (int c = tid; c < quads; c += kRankBlock)
        stage_copy16(stage + 4 * c, key_sorted + first + 4 * c);
    } else {
      for (int c = tid; c < width; c += kRankBlock) stage_copy4(stage + c, key_sorted + lo + c);
    }
    stage_wait();
    __syncthreads();
    lower_bounds(stage + (lo - first), width, q, r);
  }

#pragma unroll
  for (int k = 0; k < kRankPerThread; ++k) r[k] = q[k] > num_cells ? n : lo + r[k];
  if (whole) {
    *reinterpret_cast<int4*>(ranks + i0) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kRankPerThread; ++k)
      if (i0 + k < nq) ranks[i0 + k] = r[k];
  }
}

inline bool on_16_bytes(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace
}  // namespace tpusph

extern "C" int tpusph_qrank(const int* key_sorted, int n, const int* queries,
                            int nq, int num_cells, int* ranks,
                            cudaStream_t stream) {
  using namespace tpusph;
  if (nq > 0) {
    const bool quads_io = on_16_bytes(queries) && on_16_bytes(ranks);
    const bool quads_keys = n % 4 == 0 && on_16_bytes(key_sorted);
    const int blocks = (nq - 1) / kRankQueries + 1;
    qrank_block_kernel<<<blocks, kRankBlock, 0, stream>>>(
        key_sorted, n, queries, nq, num_cells, quads_io, quads_keys, ranks);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpusph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
