// Rate probes: the three TPU microbenchmark kernels of scripts/.
//
// Replaces:
//   scripts/vpu_microbench.py make_fma_kernel          -> tpusph_fma_probe
//   scripts/vpu_microbench.py make_density_mix_kernel  -> tpusph_density_mix
//   scripts/loop_probe.py     make_kernel (V0-V5)      -> tpusph_loop_probe
//
// They measure how fast the card runs the arithmetic of the density and
// force inner loops, timed by the slope over the round count, so each
// must do its per-round work in every round. Mosaic re-executes each
// round's loads and arithmetic; nvcc would hoist loop-invariant work out
// of the loop (the static loads of V0/V2 and every input of the density
// mix read the same addresses each round). So every per-round load here
// indexes with `r * zero`, where `zero` is a kernel argument that is 0 at
// run time: the compiler cannot prove the address invariant, and the load
// stays in the loop, still served by L1 like Mosaic's VMEM loads. It costs
// one integer add per round on the integer pipe. The TPU kernel's
// `i * 0.0` term is kept as it is. No fast-math flag is used.
//
// What bounds them on the H100: the FMA probe's chains are dependent, so
// `streams` sets the instruction-level parallelism against the FMA latency.
// The density mix sits on the SM's load path (its note below). The loop
// probe sits on one warp's issue: its candidates come from shared memory
// and pt 64 x bl 256 is one warp for each of the card's schedulers, which
// issues about two thirds of what the scheduler could take (its note
// below).
//
// Threads: one per output element (two per thread for the packed bf16
// FMA). The FMA probe launches blocks of 128 so that a small block spreads
// over many SMs; the density mix and the loop probe have their own launch
// shapes, below.

#include <cuda_bf16.h>

#include "common.cuh"
#include "probe_ops.cuh"

namespace tpusph {
namespace {

constexpr int kProbeBlock = 128;

inline int probe_blocks(int items) {
  return (items + kProbeBlock - 1) / kProbeBlock;
}

// ---------------------------------------------------------------- FMA probe
// `S` independent accumulators a_k = x + k per element, each updated
// a <- a * c1 + c2 once per round with a guaranteed FMA, then summed in
// order k = 0 .. S-1 (vpu_microbench.py:48-62).

template <int S>
__global__ void __launch_bounds__(kProbeBlock)
    fma_f32_kernel(const float* __restrict__ x, int n, int rounds,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c1 = 1.0000001f;
  const float c2 = 1e-9f;
  const float xi = x[i];
  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = xi + static_cast<float>(k);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = __fmaf_rn(acc[k], c1, c2);
  }
  float o = acc[0];
#pragma unroll
  for (int k = 1; k < S; ++k) o = o + acc[k];
  out[i] = o;
}

// bf16, two lanes per thread as a packed __nv_bfloat162 (HFMA2).
template <int S>
__global__ void __launch_bounds__(kProbeBlock)
    fma_bf16_kernel(const __nv_bfloat162* __restrict__ x, int n2, int rounds,
                    __nv_bfloat162* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 c1 = __float2bfloat162_rn(1.0000001f);
  const __nv_bfloat162 c2 = __float2bfloat162_rn(1e-9f);
  const __nv_bfloat162 xi = x[i];
  __nv_bfloat162 acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k)
    acc[k] = __hadd2(xi, __float2bfloat162_rn(static_cast<float>(k)));
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = __hfma2(acc[k], c1, c2);
  }
  __nv_bfloat162 o = acc[0];
#pragma unroll
  for (int k = 1; k < S; ++k) o = __hadd2(o, acc[k]);
  out[i] = o;
}

// ------------------------------------------------------ density-mix probe
// The density inner loop's op mix on a (pt, 128) block of pair-lanes
// (vpu_microbench.py:85-111): per round, load the candidate columns,
// r^2 = dx^2 + dy^2 + dz^2, key compare |ck - tk| <= 1 and the lane mask
// lane < 100 + i*0 (both in f32), w = max(h^2 - r^2, 0)^3, masked add.
// t is (>= pt, 4) rows (x, y, z, key); c is (8, 128), rows x, y, z, key.
//
// One thread per pair-lane. A round is a chain load -> sub -> mul/fma ->
// max -> mul -> mul -> select -> add, and a (128, 128) block is 512 warps
// on the card's 528 schedulers, one warp each. The first design took the
// rounds one by one in blocks of 128 threads.
// Here the loop body takes kMixUnroll = 16 rounds: it issues their 64
// loads, computes the 16 terms, which do not depend on each other, and adds
// them to the accumulator in round order, so the sum is the same bits as
// round by round; a second loop takes the rounds % kMixUnroll left. Every
// round keeps its own `r * zero` index and its own `r` in the lane mask.
// Blocks are single warps (kMixBlock = 32): the four warps of a 128-thread
// block run in step and meet at the SM's load path every round, warps of
// separate blocks drift apart and a warp runs as fast as one alone on its
// SM. A pair-lane's rounds are never split across threads, which would
// reorder its sum, so pt 8 (32 warps) and pt 64 (256 warps) cannot fill the
// card.
//
// What bounds it on the H100 is the load path, not the schedulers: the four
// loads of a round are four 128-byte requests a warp, and an SM moves about
// 64 bytes of such loads a clock (measured: the best rate, at pt 256, is
// 16 bytes a pair-lane and round at that width), while a round's ~23
// instructions would take half that time to issue. Bit-equal sums leave no
// way to load less: one thread summing several targets of one lane would
// share the loads, but at these block sizes it leaves schedulers without a
// warp and measured slower.

constexpr int kMixBlock = 32;
constexpr int kMixUnroll = 16;

template <class A>
__global__ void __launch_bounds__(kMixBlock)
    density_mix_kernel(const typename A::T* __restrict__ t,
                       const typename A::T* __restrict__ c, int pt, int rounds,
                       int zero, float* __restrict__ out) {
  using T = typename A::T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pt * 128) return;
  const int p = i >> 7;
  const int lane = i & 127;
  const T tx = t[4 * p];
  const T ty = t[4 * p + 1];
  const T tz = t[4 * p + 2];
  const float tk = A::to_f32(t[4 * p + 3]);
  const T h2 = A::from_f32(0.01f);
  const T z0 = A::from_f32(0.0f);
  const float lanef = static_cast<float>(lane);
  const T* __restrict__ cl = c + lane;

  // One round's masked term from its loaded candidate.
  auto term = [&](int r, T cx, T cy, T cz, T ckey) {
    const float ck = A::to_f32(ckey);
    const T dx = A::sub(tx, cx);
    const T dy = A::sub(ty, cy);
    const T dz = A::sub(tz, cz);
    const T r2 = A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz));
    const bool keyhit = fabsf(ck - tk) <= 1.0f;
    const bool live = keyhit && (lanef < 100.0f + static_cast<float>(r) * 0.0f);
    T w = A::max(A::sub(h2, r2), z0);
    w = A::mul(A::mul(w, w), w);
    return live ? w : z0;
  };

  T acc = z0;
  int r = 0;
  for (; r + kMixUnroll <= rounds; r += kMixUnroll) {
    T cx[kMixUnroll], cy[kMixUnroll], cz[kMixUnroll], ck[kMixUnroll], w[kMixUnroll];
#pragma unroll
    for (int u = 0; u < kMixUnroll; ++u) {
      const int o = (r + u) * zero;  // 0 at run time; keeps the loads in the loop
      cx[u] = cl[o];
      cy[u] = cl[128 + o];
      cz[u] = cl[256 + o];
      ck[u] = cl[384 + o];
    }
#pragma unroll
    for (int u = 0; u < kMixUnroll; ++u) w[u] = term(r + u, cx[u], cy[u], cz[u], ck[u]);
#pragma unroll
    for (int u = 0; u < kMixUnroll; ++u) acc = A::add(acc, w[u]);  // in round order
  }
#pragma unroll 1
  for (; r < rounds; ++r) {
    const int o = r * zero;
    acc = A::add(acc, term(r, cl[o], cl[128 + o], cl[256 + o], cl[384 + o]));
  }
  out[i] = A::to_f32(acc);
}

// ------------------------------------------------------- loop-overhead probe
// loop_probe.py:54-127. For each of the (pt, bl) pair-lanes, over candidate
// blocks b = 0 .. n-1: load cand[0..2][off_b + l] and add the density term
// max(h^2 - r^2, 0)^3, or the force op mix (V5: rsqrt, r >= eps, three
// sums added at the end).
//   kDynTrip: n = desc[rounds], read from the table (the TPU's SMEM scalar);
//             otherwise n = kRounds, a compile-time constant.
//   kDynLoad: off_b = desc[b] * 128; otherwise off_b = 0 (indexed `b * zero`).
//   kPair:    blocks per iteration of the script's loop (V4: 2, so an odd
//             last block is not taken).
// desc is the TPU's scalar-prefetch table (int16, rounds + 8 entries).
//
// The first design gave each pair-lane a thread in blocks
// of 128 and took the rounds one by one: a 2-byte load of the desc entry,
// then the three candidate loads whose address needs it, then the
// arithmetic, about 160 clocks a round for some 20 instructions, with one
// warp on each of the card's schedulers. What this design does about it:
//   * Rounds in flight. The main loop takes kLoopUnroll = 32 rounds: it
//     reads their desc entries, issues their 3 x 32 candidate loads,
//     computes the 32 terms, which do not depend on each other, and adds
//     them in round order into the pair-lane's one sum (three for the
//     force), so the order of the adds is the first design's and so are the
//     bits. A second loop takes the n % 32 rounds left (V4: two an
//     iteration).
//   * Registers for them. `__launch_bounds__(threads, kLoopResident)`:
//     without its second argument ptxas keeps these kernels within 64
//     registers and interleaves loads and arithmetic to fit, and with one
//     warp a scheduler every wait of that schedule shows: the same source
//     then ran V5 in 0.115-0.146 ms depending on incidental code shape.
//     Told that an SM holds kLoopResident = 4 blocks (four tables of 48 KB),
//     it takes up to 161 registers and the times settle.
//   * The table by 16-byte loads, a loop iteration ahead. 32 int16 entries
//     are 4 loads of 16 bytes at an address every thread shares; the next
//     iteration's are loaded, without a branch, at the head of this one, so
//     no candidate load waits for a table load (the last iteration loads its
//     own again). They never leave the tensor (an iteration's entries lie
//     below n <= rounds). A desc off a 16-byte boundary is read entry by
//     entry, by the loop of single rounds.
//   * The candidates on chip, as on the TPU, where the whole table is a
//     VMEM block. A warp owns 32 lanes l, so of cand's rows 0-2 it reads
//     only the 32 floats at d * 128 + slice * 32 of each block offset d: a
//     block copies those (3 x D x 128 bytes, D = (cap - bl) / 128 + 1; 48 KB
//     at cap 16,384) into shared memory once by 16-byte cp.async and reads
//     d * 32 + lane there, consecutive lanes on consecutive banks. Where bl
//     is no multiple of 32, cand is off 16 bytes, cap no multiple of 4 or
//     the table larger than kLoopStageMax, the caller passes stage_d = 0 and
//     the same loop reads device memory through L1 (`loop_walk<.., false>`).
//   * Blocks of kLoopWarps = 2 warps on one 32-lane slice and two targets
//     share one table: 256 blocks at pt 64, 512 at pt 128, four an SM, all
//     resident, with 255 registers a thread to take.
//   * kLoopTargets = 1 target a thread; more would share each candidate's
//     loads, every pair-lane keeping its own sum in round order.
// Every round keeps its own three loads and its own arithmetic: the static
// variants index with `b * zero`, in shared memory as in device memory.
//
// Why these values (H100 80GB HBM3 at 700 W, bl 256, 4,096 rounds, device ms
// of a call at pt 64 unless said; `python -m
// tpusph_torch.scripts.loop_probe_sweep`, PERF.md). The staged table is what
// the entry point reports: faster than device memory on every variant by
// the script's slope and per call, copy included (V3 0.067 against 0.100
// ms, V5 0.099 against 0.135). Rounds in flight 8 / 16 / 32: V3 0.086 / 0.073
// / 0.067, V1 0.089 / 0.070 / 0.065; V5 0.126 / 0.100 / 0.099. Blocks of 1, 2
// or 4 warps run V0-V4 alike at pt 8 and 64 (within 5 %), but four warps a
// block leave a thread 128 registers and V5 0.119 ms, and at pt 128 one-warp
// blocks of 48 KB run in two waves (V3 0.131 against 0.100 ms). Two or four
// targets a thread lose at pt 64 (V3 0.105 and 0.124 ms: half and a quarter
// of the warps for the same schedulers) and at pt 8; at pt 128 two are no
// better on V3 (0.106 against 0.100) and better on V0 and V5. The SASS of
// the staged main loops holds each round's 3 LDS; by the slope the kernel
// issues 0.60-0.75 of a round's instructions on every scheduler
// (chip_smoke.py prints the counts). What is left is one warp's issue, not
// the load path (V3 moves 49 bytes a clock and SM out of shared memory): at
// pt 128, two warps a scheduler, V3 passes 1,430 Gpair-lanes/s against
// 1,080 at pt 64. A pair-lane's rounds are never split across threads, so
// pt 8 (64 warps) leaves seven of eight schedulers idle and takes as long
// as pt 64.

constexpr int kLoopUnroll = 32;    // rounds in flight a thread
constexpr int kLoopWarps = 2;      // warps a block
constexpr int kLoopTargets = 1;    // targets a thread
constexpr int kLoopResident = 4;   // blocks an SM is to hold: four tables of 48 KB
constexpr int kLoopStageMax = 232448;  // bytes of shared memory a block may stage

static_assert(kLoopUnroll % 8 == 0, "a loop iteration reads its desc entries in 16-byte loads");

__device__ __forceinline__ void loop_copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void loop_copy_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// U consecutive desc entries, two to a word.
template <int U>
struct DescBlock {
  int w[U / 2];
  __device__ __forceinline__ int at(int u) const {
    return (u & 1) ? (w[u >> 1] >> 16) : static_cast<int>(static_cast<short>(w[u >> 1]));
  }
};

// desc on 16 bytes and b a multiple of 8: U / 8 loads of 16 bytes.
template <int U>
__device__ __forceinline__ DescBlock<U> load_desc(const short* __restrict__ desc, int b) {
  DescBlock<U> d;
  const int4* __restrict__ src = reinterpret_cast<const int4*>(desc + b);
#pragma unroll
  for (int q = 0; q < U / 8; ++q) {
    const int4 v = __ldg(src + q);
    d.w[4 * q] = v.x;
    d.w[4 * q + 1] = v.y;
    d.w[4 * q + 2] = v.z;
    d.w[4 * q + 3] = v.w;
  }
  return d;
}

// One thread's walk over the blocks, from the staged table (kStaged: `src`
// is the block's table at this lane, rows `row` = D * 32 floats apart, block
// offset d at d * 32) or from device memory (`src` is cand + l, rows `row` =
// cap apart, block offset d at d * 128).
template <bool kDynTrip, bool kDynLoad, int kPair, bool kForce, int kRounds, bool kStaged>
__device__ __forceinline__ void loop_walk(const short* __restrict__ desc,
                                          const float* __restrict__ t,
                                          const float* __restrict__ src, int row, int pt,
                                          int bl, int p0, int l, int rounds, int zero,
                                          float* __restrict__ out) {
  constexpr int U = kLoopUnroll;
  constexpr int K = kLoopTargets;
  constexpr int kStep = kStaged ? 32 : 128;
  const float h2 = 0.01f;
  const float h = 0.1f;
  const float eps = 1e-4f;
  float tx[K], ty[K], tz[K];
  float ax[K], ay[K], az[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = min(p0 + k, pt - 1);  // a last group short of K repeats its last target
    tx[k] = t[4 * p];
    ty[k] = t[4 * p + 1];
    tz[k] = t[4 * p + 2];
    ax[k] = 0.0f;
    ay[k] = 0.0f;
    az[k] = 0.0f;
  }
  const int trip = kDynTrip ? static_cast<int>(__ldg(desc + rounds)) : kRounds;
  const int n = trip - trip % kPair;

  auto load = [&](int off) {
    if constexpr (kStaged) {
      return src[off];
    } else {
      return __ldg(src + off);
    }
  };
  // What one round adds for target k, computed from its loaded candidate ...
  struct Term {
    float a, b, dx, dy, dz;  // density: w, w^2; force: s_p, s_v and the displacement
  };
  auto term = [&](int k, float cx, float cy, float cz) {
    Term m;
    m.dx = tx[k] - cx;
    m.dy = ty[k] - cy;
    m.dz = tz[k] - cz;
    const float r2 = m.dx * m.dx + m.dy * m.dy + m.dz * m.dz;
    if constexpr (kForce) {
      const float inv_r = rsqrtf(r2);
      const float r = r2 * inv_r;
      const bool live = r >= eps;
      const float hr = fmaxf(h - r, 0.0f);
      m.a = live ? hr * hr * inv_r : 0.0f;
      m.b = live ? hr : 0.0f;
    } else {
      m.a = fmaxf(h2 - r2, 0.0f);
      m.b = m.a * m.a;
    }
    return m;
  };
  // ... and the adds, which run in round order.
  auto add = [&](int k, const Term& m, float cx, float cy, float cz) {
    if constexpr (kForce) {
      ax[k] = ax[k] + m.a * m.dx;
      ay[k] = ay[k] + m.a * m.dy;
      az[k] = az[k] + m.a * m.dz;
      ax[k] = ax[k] + m.b * cx;
      ay[k] = ay[k] + m.b * cy;
      az[k] = az[k] + m.b * cz;
    } else {
      ax[k] = ax[k] + m.b * m.a;
    }
  };

  int b = 0;
  // A desc off a 16-byte boundary leaves every round to the loop below.
  if (n >= U && (!kDynLoad || (reinterpret_cast<size_t>(desc) & 15) == 0)) {
    DescBlock<U> cur = {};
    if constexpr (kDynLoad) cur = load_desc<U>(desc, 0);
    for (; b + U <= n; b += U) {
      DescBlock<U> next = cur;
      if constexpr (kDynLoad) {  // no branch: the loads stay at the head of the iteration
        // the next iteration's entries; the last iteration loads its own again
        next = load_desc<U>(desc, b + 2 * U <= n ? b + U : b);
      }
      float cx[U], cy[U], cz[U];
      Term m[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int off = kDynLoad ? cur.at(u) * kStep : (b + u) * zero;
        cx[u] = load(off);
        cy[u] = load(row + off);
        cz[u] = load(2 * row + off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) m[u][k] = term(k, cx[u], cy[u], cz[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) add(k, m[u][k], cx[u], cy[u], cz[u]);
      }
      cur = next;
    }
  }
#pragma unroll 1
  for (; b < n; b += kPair) {
#pragma unroll
    for (int j = 0; j < kPair; ++j) {
      const int off = kDynLoad ? static_cast<int>(__ldg(desc + b + j)) * kStep : (b + j) * zero;
      const float cx = load(off);
      const float cy = load(row + off);
      const float cz = load(2 * row + off);
#pragma unroll
      for (int k = 0; k < K; ++k) add(k, term(k, cx, cy, cz), cx, cy, cz);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (p0 + k < pt) out[(p0 + k) * bl + l] = kForce ? ax[k] + ay[k] + az[k] : ax[k];
  }
}

// Blocks: one 32-lane slice of the output's columns and kLoopWarps groups of
// kLoopTargets targets each; stage_d = D stages the slice's table, 0 reads
// device memory.
template <bool kDynTrip, bool kDynLoad, int kPair, bool kForce, int kRounds>
__global__ void __launch_bounds__(kLoopWarps * 32, kLoopResident)
    loop_probe_kernel(const short* __restrict__ desc, const float* __restrict__ t,
                      const float* __restrict__ cand, int cap, int pt, int bl,
                      int rounds, int zero, int stage_d, float* __restrict__ out) {
  extern __shared__ float4 loop_stage[];
  float* stage = reinterpret_cast<float*>(loop_stage);
  const int lane = threadIdx.x & 31;
  const int groups = (pt + kLoopTargets - 1) / kLoopTargets;
  const int per_slice = (groups + kLoopWarps - 1) / kLoopWarps;  // blocks a slice
  const int slice = blockIdx.x / per_slice;
  const int group = (blockIdx.x - slice * per_slice) * kLoopWarps + (threadIdx.x >> 5);
  const int l = slice * 32 + lane;
  if (stage_d > 0) {  // the same for every thread of the grid
    const int per_row = stage_d * 8;  // 16-byte pieces of one row's table
    for (int c = threadIdx.x; c < 3 * per_row; c += kLoopWarps * 32) {
      const int r = c / per_row;
      const int piece = c - r * per_row;
      loop_copy16(stage + 4 * c, cand + static_cast<size_t>(r) * cap + (piece >> 3) * 128 +
                                     slice * 32 + (piece & 7) * 4);
    }
    loop_copy_wait();
    __syncthreads();
  }
  if (l >= bl || group >= groups) return;
  const int p0 = group * kLoopTargets;
  if (stage_d > 0) {
    loop_walk<kDynTrip, kDynLoad, kPair, kForce, kRounds, true>(
        desc, t, stage + lane, stage_d * 32, pt, bl, p0, l, rounds, zero, out);
  } else {
    loop_walk<kDynTrip, kDynLoad, kPair, kForce, kRounds, false>(
        desc, t, cand + l, cap, pt, bl, p0, l, rounds, zero, out);
  }
}

// Launches one instantiation. A table above 48 KB needs the kernel's limit
// raised, once an instantiation. Four blocks of 48 KB fit an SM only with
// its whole carve-out as shared memory, while the device-memory path wants
// it as L1: the preference is set again where it changes.
template <bool kDynTrip, bool kDynLoad, int kPair, bool kForce, int kRounds>
cudaError_t launch_loop(const short* desc, const float* t, const float* cand, int cap,
                        int pt, int bl, int rounds, int stage_d, float* out,
                        cudaStream_t stream) {
  auto kernel = loop_probe_kernel<kDynTrip, kDynLoad, kPair, kForce, kRounds>;
  static const cudaError_t raised = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLoopStageMax);
  if (raised != cudaSuccess) return raised;
  static int carveout = cudaSharedmemCarveoutDefault;
  const int wanted = stage_d > 0 ? cudaSharedmemCarveoutMaxShared : cudaSharedmemCarveoutMaxL1;
  if (carveout != wanted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, wanted);
    if (err != cudaSuccess) return err;
    carveout = wanted;
  }
  const int bytes = 3 * stage_d * 128;
  if (stage_d < 0 || bytes > kLoopStageMax) return cudaErrorInvalidValue;
  if (stage_d > 0 && (bl % 32 != 0 || cap % 4 != 0 || (reinterpret_cast<size_t>(cand) & 15) ||
                      (stage_d - 1) * 128 + bl > cap)) {
    return cudaErrorInvalidValue;  // the copies would leave cand or split a 16-byte piece
  }
  const int groups = (pt + kLoopTargets - 1) / kLoopTargets;
  const int blocks = ((bl + 31) / 32) * ((groups + kLoopWarps - 1) / kLoopWarps);
  kernel<<<blocks, kLoopWarps * 32, bytes, stream>>>(desc, t, cand, cap, pt, bl, rounds, 0,
                                                     stage_d, out);
  return cudaSuccess;
}

template <bool kDynLoad>
cudaError_t launch_static_trip(const short* desc, const float* t, const float* cand,
                               int cap, int pt, int bl, int rounds, int stage_d,
                               float* out, cudaStream_t stream) {
  switch (rounds) {  // the instantiated trip counts: probes.STATIC_ROUNDS
    case 1:
      return launch_loop<false, kDynLoad, 1, false, 1>(desc, t, cand, cap, pt, bl, rounds,
                                                       stage_d, out, stream);
    case 64:
      return launch_loop<false, kDynLoad, 1, false, 64>(desc, t, cand, cap, pt, bl, rounds,
                                                        stage_d, out, stream);
    case 67:
      return launch_loop<false, kDynLoad, 1, false, 67>(desc, t, cand, cap, pt, bl, rounds,
                                                        stage_d, out, stream);
    case 4096:
      return launch_loop<false, kDynLoad, 1, false, 4096>(desc, t, cand, cap, pt, bl, rounds,
                                                          stage_d, out, stream);
    case 16384:
      return launch_loop<false, kDynLoad, 1, false, 16384>(desc, t, cand, cap, pt, bl,
                                                           rounds, stage_d, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpusph

// x and out: n elements of f32 (bf16 = 0) or bf16 (bf16 = 1; n even).
extern "C" int tpusph_fma_probe(const void* x, int n, int streams, int rounds,
                                int bf16, void* out, cudaStream_t stream) {
  using namespace tpusph;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (streams != 1 && streams != 4 && streams != 8) return cudaErrorInvalidValue;
  if (bf16) {
    if (n % 2) return cudaErrorInvalidValue;
    const int n2 = n / 2;
    const auto* xi = static_cast<const __nv_bfloat162*>(x);
    auto* o = static_cast<__nv_bfloat162*>(out);
    const int g = probe_blocks(n2);
    if (streams == 1) fma_bf16_kernel<1><<<g, kProbeBlock, 0, stream>>>(xi, n2, rounds, o);
    if (streams == 4) fma_bf16_kernel<4><<<g, kProbeBlock, 0, stream>>>(xi, n2, rounds, o);
    if (streams == 8) fma_bf16_kernel<8><<<g, kProbeBlock, 0, stream>>>(xi, n2, rounds, o);
  } else {
    const auto* xi = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    const int g = probe_blocks(n);
    if (streams == 1) fma_f32_kernel<1><<<g, kProbeBlock, 0, stream>>>(xi, n, rounds, o);
    if (streams == 4) fma_f32_kernel<4><<<g, kProbeBlock, 0, stream>>>(xi, n, rounds, o);
    if (streams == 8) fma_f32_kernel<8><<<g, kProbeBlock, 0, stream>>>(xi, n, rounds, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// t: (>= pt, 4), c: (8, 128), both f32 (bf16 = 0) or bf16 (bf16 = 1);
// out: f32 (pt, 128).
extern "C" int tpusph_density_mix(const void* t, const void* c, int pt, int rounds,
                                  int bf16, float* out, cudaStream_t stream) {
  using namespace tpusph;
  if (pt > 0) {
    const int g = (pt * 128 + kMixBlock - 1) / kMixBlock;
    if (bf16) {
      density_mix_kernel<BF16Ops><<<g, kMixBlock, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(c),
          pt, rounds, 0, out);
    } else {
      density_mix_kernel<F32Ops><<<g, kMixBlock, 0, stream>>>(
          static_cast<const float*>(t), static_cast<const float*>(c), pt, rounds, 0,
          out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// desc: int16 (rounds + 8); t: f32 (>= pt, 4); cand: f32 (8, cap);
// out: f32 (pt, bl); variant 0-5 is V0-V5 of loop_probe.py. V0 and V1 take
// their trip count at compile time and accept rounds in {1, 64, 67, 4096,
// 16384}. stage_d: block offsets 0 .. stage_d - 1 of cand's rows 0-2 staged
// in shared memory (probes.loop_stage_blocks), or 0 to read device memory.
extern "C" int tpusph_loop_probe(const short* desc, const float* t,
                                 const float* cand, int cap, int pt, int bl,
                                 int rounds, int variant, int stage_d, float* out,
                                 cudaStream_t stream) {
  using namespace tpusph;
  if (pt <= 0 || bl <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0:  // static trip, static loads
      err = launch_static_trip<false>(desc, t, cand, cap, pt, bl, rounds, stage_d, out, stream);
      break;
    case 1:  // static trip, desc-table loads
      err = launch_static_trip<true>(desc, t, cand, cap, pt, bl, rounds, stage_d, out, stream);
      break;
    case 2:  // desc-table trip, static loads
      err = launch_loop<true, false, 1, false, 0>(desc, t, cand, cap, pt, bl, rounds, stage_d,
                                                  out, stream);
      break;
    case 3:  // desc-table trip and loads
      err = launch_loop<true, true, 1, false, 0>(desc, t, cand, cap, pt, bl, rounds, stage_d,
                                                 out, stream);
      break;
    case 4:  // V3, two blocks a loop iteration
      err = launch_loop<true, true, 2, false, 0>(desc, t, cand, cap, pt, bl, rounds, stage_d,
                                                 out, stream);
      break;
    case 5:  // V3 with the force op mix
      err = launch_loop<true, true, 1, true, 0>(desc, t, cand, cap, pt, bl, rounds, stage_d,
                                                out, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
