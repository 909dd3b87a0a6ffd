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
// What bounds them on the H100: nothing but issue and latency. The FMA
// probe's chains are dependent, so `streams` sets the instruction-level
// parallelism against the FMA latency; the other two issue ~20-30
// instructions per pair-lane per round from registers and L1.
//
// Threads: one per output element (two per thread for the packed bf16
// FMA). The FMA and loop probes launch blocks of 128 so that a small block
// spreads over many SMs; the density mix has its own launch shape, below.

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
// on the card's 528 schedulers, one warp each. The first design
// (sph_baseline.cu) took the rounds one by one in blocks of 128 threads.
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
// loop_probe.py:54-127. Each thread owns one element (p, l) of the (pt, bl)
// output and walks the candidate blocks b = 0 .. n-1: it loads
// cand[0..2][off_b + l] and accumulates the density op mix, or the force op
// mix (V5: rsqrt, r >= eps, three accumulators summed at the end).
//   kDynTrip: n = desc[rounds], read from the table (the TPU's SMEM scalar);
//             otherwise n = kRounds, a compile-time constant.
//   kDynLoad: off_b = desc[b] * 128; otherwise off_b = 0.
//   kUnroll:  blocks per loop iteration (V4: 2).
// desc is the TPU's scalar-prefetch table (int16, rounds + 8 entries). All
// threads read the same entry at the same time, so it is read with a
// uniform __ldg: one broadcast load through L1 per warp.

template <bool kDynTrip, bool kDynLoad, int kUnroll, bool kForce, int kRounds>
__global__ void __launch_bounds__(kProbeBlock)
    loop_probe_kernel(const short* __restrict__ desc, const float* __restrict__ t,
                      const float* __restrict__ cand, int cap, int pt, int bl,
                      int rounds, int zero, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pt * bl) return;
  const int p = i / bl;
  const int l = i - p * bl;
  const float tx = t[4 * p];
  const float ty = t[4 * p + 1];
  const float tz = t[4 * p + 2];
  const float h2 = 0.01f;
  const float h = 0.1f;
  const float eps = 1e-4f;
  const int n = kDynTrip ? static_cast<int>(__ldg(desc + rounds)) : kRounds;
  float ax = 0.0f;
  float ay = 0.0f;
  float az = 0.0f;

  auto one = [&](int b) {
    const int off = (kDynLoad ? static_cast<int>(__ldg(desc + b)) * 128 : b * zero) + l;
    const float cx = __ldg(cand + off);
    const float cy = __ldg(cand + cap + off);
    const float cz = __ldg(cand + 2 * cap + off);
    const float dx = tx - cx;
    const float dy = ty - cy;
    const float dz = tz - cz;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if constexpr (kForce) {
      const float inv_r = rsqrtf(r2);
      const float r = r2 * inv_r;
      const bool live = r >= eps;
      const float hr = fmaxf(h - r, 0.0f);
      const float s_p = live ? hr * hr * inv_r : 0.0f;
      ax = ax + s_p * dx;
      ay = ay + s_p * dy;
      az = az + s_p * dz;
      const float s_v = live ? hr : 0.0f;
      ax = ax + s_v * cx;
      ay = ay + s_v * cy;
      az = az + s_v * cz;
    } else {
      const float w = fmaxf(h2 - r2, 0.0f);
      ax = ax + w * w * w;
    }
  };

  for (int b = 0; b < n / kUnroll; ++b) {
    if constexpr (kUnroll == 1) {
      one(b);
    } else {
      one(2 * b);
      one(2 * b + 1);
    }
  }
  out[i] = kForce ? ax + ay + az : ax;
}

template <bool kDynLoad, int kRounds>
void launch_rounds(const short* desc, const float* t, const float* cand,
                        int cap, int pt, int bl, int rounds, float* out,
                        cudaStream_t stream) {
  loop_probe_kernel<false, kDynLoad, 1, false, kRounds>
      <<<probe_blocks(pt * bl), kProbeBlock, 0, stream>>>(desc, t, cand, cap, pt,
                                                          bl, rounds, 0, out);
}

template <bool kDynLoad>
cudaError_t launch_static_trip(const short* desc, const float* t,
                               const float* cand, int cap, int pt, int bl,
                               int rounds, float* out, cudaStream_t stream) {
  switch (rounds) {  // the instantiated trip counts: kLoopProbeStaticRounds
    case 64:
      launch_rounds<kDynLoad, 64>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      return cudaSuccess;
    case 4096:
      launch_rounds<kDynLoad, 4096>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      return cudaSuccess;
    case 16384:
      launch_rounds<kDynLoad, 16384>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDynLoad, int kUnroll, bool kForce>
void launch_dynamic_trip(const short* desc, const float* t, const float* cand,
                         int cap, int pt, int bl, int rounds, float* out,
                         cudaStream_t stream) {
  loop_probe_kernel<true, kDynLoad, kUnroll, kForce, 0>
      <<<probe_blocks(pt * bl), kProbeBlock, 0, stream>>>(desc, t, cand, cap, pt,
                                                          bl, rounds, 0, out);
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
// their trip count at compile time and accept rounds in {64, 4096, 16384}.
extern "C" int tpusph_loop_probe(const short* desc, const float* t,
                                 const float* cand, int cap, int pt, int bl,
                                 int rounds, int variant, float* out,
                                 cudaStream_t stream) {
  using namespace tpusph;
  if (pt <= 0 || bl <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0:  // static trip, static loads
      err = launch_static_trip<false>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      break;
    case 1:  // static trip, desc-table loads
      err = launch_static_trip<true>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      break;
    case 2:  // desc-table trip, static loads
      launch_dynamic_trip<false, 1, false>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      break;
    case 3:  // desc-table trip and loads
      launch_dynamic_trip<true, 1, false>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      break;
    case 4:  // V3 unrolled x2
      launch_dynamic_trip<true, 2, false>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      break;
    case 5:  // V3 with the force op mix
      launch_dynamic_trip<true, 1, true>(desc, t, cand, cap, pt, bl, rounds, out, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
