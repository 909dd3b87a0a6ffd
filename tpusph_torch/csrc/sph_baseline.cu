// The first designs of the kernels that were later redesigned for the
// H100, kept as the baselines that `chip_smoke.py` and the GPU tests time
// and compare the redesigned kernels against (baseline, new, new, baseline
// on one card): the density and force passes (now sph.cu), the rank of
// queries (now qrank.cu), the density-mix probe and the loop probe (now
// probes.cu). The kernels are unchanged from their first version; only the
// kernels' and entry points' names differ (tpusph_*_baseline). The engine
// and the probe scripts never launch them.
//
// Replaces tpusph/pallas/fused.py, like sph.cu:
//   density_pallas / _density_kernel -> tpusph_density_baseline
//   force_pallas   / _force_kernel   -> tpusph_force_baseline
//
// Each thread owns one sorted target and walks its own 9 windows straight
// from the starts table: for neighbour column (dy, dz), off = dy*C + dz*C*C,
// the candidates are the sorted rows starts[lo] .. starts[hi] with
//   lo = clip(k + off - 1, 0, nc),  hi = clip(k + off + 2, lo, nc).
// These ranges are exactly the key-mask hit set of the JAX tile pass
// (engine/step.py _density_pass_sorted), and the 9 ranges of one target are
// disjoint, so no mask is needed. Every window is walked to its end: there
// is no candidate capacity, so nothing can overflow. hi <= nc keeps the
// padding rows (key nc, sorted to the end) out of every window. Sums are
// taken in a fixed order without atomics, so results repeat bit for bit.
//
// Distances use the exact displacement form dx*dx + dy*dy + dz*dz in fp32
// on the CUDA cores; the |t|^2 + |c|^2 - 2 t.c identity on tensor cores
// loses the 1e-4 density budget to cancellation (fused.py:30-33).
//
// Bound by load latency (each candidate is 3 or 8 dependent __ldg gathers
// after two loads of the starts table) and by warp divergence, where the
// 9 window lengths differ within a warp; sph.cu says what the tiled design
// does about both. The rank, the density-mix probe and the loop probe have
// their notes at their kernels below.

#include "common.cuh"
#include "probe_ops.cuh"

namespace tpusph {
namespace {

struct Window {
  int begin;
  int end;
};

__device__ __forceinline__ Window column_window(const int* __restrict__ starts,
                                                int key, int off, int nc) {
  const int lo = min(max(key + off - 1, 0), nc);
  const int hi = min(max(key + off + 2, lo), nc);
  return {__ldg(starts + lo), __ldg(starts + hi)};
}

// Raw density m * d_coeff * sum_j (h^2 - r^2)^3 over candidates with
// r^2 <= h^2, the target itself included (poly6 has no self-exclusion).
// Sentinel rows (key >= nc) write 0.
__global__ void __launch_bounds__(kBlock)
    density_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, const int* __restrict__ key,
                   const int* __restrict__ starts, int n, int C, int nc,
                   float h2, float scale, float* __restrict__ rho) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  if (k >= nc) {
    rho[i] = 0.0f;
    return;
  }
  const float xi = x[i];
  const float yi = y[i];
  const float zi = z[i];
  float acc = 0.0f;
  for (int dz = -1; dz <= 1; ++dz) {
    for (int dy = -1; dy <= 1; ++dy) {
      const Window w = column_window(starts, k, dy * C + dz * C * C, nc);
      for (int j = w.begin; j < w.end; ++j) {
        const float ddx = xi - __ldg(x + j);
        const float ddy = yi - __ldg(y + j);
        const float ddz = zi - __ldg(z + j);
        const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
        if (r2 <= h2) {
          const float d = h2 - r2;
          acc += d * d * d;
        }
      }
    }
  }
  rho[i] = scale * acc;
}

// Pressure plus viscosity force on each sorted target, the per-pair
// arithmetic of physics/kernels.py pair_force with both of its guards:
//   pressure  (r^2 <= h^2, r >= eps): -m (p_i + p_j) / (2 rho_j) * grad,
//             grad = disp * (-vk (h - r)^2 / r)
//   viscosity (r <= h,     r >= eps): mu m vk (h - r) / rho_j * (v_j - v_i)
// r >= eps drops the self pair. Output is field-major f[3][n]; sentinel
// rows write 0.
__global__ void __launch_bounds__(kBlock)
    force_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, const float* __restrict__ vx,
                 const float* __restrict__ vy, const float* __restrict__ vz,
                 const float* __restrict__ rho, const float* __restrict__ p,
                 const int* __restrict__ key, const int* __restrict__ starts,
                 int n, int C, int nc, float h, float h2, float eps, float m,
                 float vk, float mu, float* __restrict__ f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  float ax = 0.0f;
  float ay = 0.0f;
  float az = 0.0f;
  if (k < nc) {
    const float xi = x[i];
    const float yi = y[i];
    const float zi = z[i];
    const float vxi = vx[i];
    const float vyi = vy[i];
    const float vzi = vz[i];
    const float pi = p[i];
    const float mu_m = mu * m;
    for (int dz = -1; dz <= 1; ++dz) {
      for (int dy = -1; dy <= 1; ++dy) {
        const Window w = column_window(starts, k, dy * C + dz * C * C, nc);
        for (int j = w.begin; j < w.end; ++j) {
          const float ddx = xi - __ldg(x + j);
          const float ddy = yi - __ldg(y + j);
          const float ddz = zi - __ldg(z + j);
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          // Past r^2 <= h^2 the pressure term is off, and the viscosity
          // term is off too or, at sqrt rounding to r == h, exactly 0.
          if (r2 > h2) continue;
          const float r = sqrtf(r2);
          if (r < eps) continue;  // self pair
          const float rho_j = __ldg(rho + j);
          const float hr = h - r;
          const float grad = (-vk) * (hr * hr) / r;
          const float coef = (-m) * (pi + __ldg(p + j)) / (2.0f * rho_j);
          float fx = coef * (ddx * grad);
          float fy = coef * (ddy * grad);
          float fz = coef * (ddz * grad);
          if (r <= h) {
            const float visc = mu_m * (vk * hr) / rho_j;
            fx += visc * (__ldg(vx + j) - vxi);
            fy += visc * (__ldg(vy + j) - vyi);
            fz += visc * (__ldg(vz + j) - vzi);
          }
          ax += fx;
          ay += fy;
          az += fz;
        }
      }
    }
  }
  f[i] = ax;
  f[n + i] = ay;
  f[2 * n + i] = az;
}

// The first rank kernel (replaces tpusph/pallas/qrank.py rank_queries_pallas,
// like qrank.cu): ranks[i] = #{j : key_sorted[j] < queries[i]}, every query
// a lower-bound binary search over the whole array by one thread. The keys
// (1 MB at 262,144 particles) stay in L2 and neighbouring queries walk
// nearly the same path, but each query waits for about log2(n) = 18
// dependent loads; qrank.cu says what the block-narrowed design does about
// that. Queries above num_cells answer n.
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

// The first density-mix probe (replaces scripts/vpu_microbench.py
// make_density_mix_kernel, like probes.cu, which describes the op mix and
// the `r * zero` index): one thread per pair-lane in blocks of 128, the
// rounds taken one by one, each a dependent chain from its four loads to
// the add.
constexpr int kMixBaselineBlock = 128;

template <class A>
__global__ void __launch_bounds__(kMixBaselineBlock)
    density_mix_baseline_kernel(const typename A::T* __restrict__ t,
                                const typename A::T* __restrict__ c, int pt,
                                int rounds, int zero, float* __restrict__ out) {
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
  T acc = z0;
  for (int r = 0; r < rounds; ++r) {
    const int o = r * zero;  // 0 at run time; keeps the loads in the loop
    const T cx = cl[o];
    const T cy = cl[128 + o];
    const T cz = cl[256 + o];
    const float ck = A::to_f32(cl[384 + o]);
    const T dx = A::sub(tx, cx);
    const T dy = A::sub(ty, cy);
    const T dz = A::sub(tz, cz);
    const T r2 = A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz));
    const bool keyhit = fabsf(ck - tk) <= 1.0f;
    const bool live = keyhit && (lanef < 100.0f + static_cast<float>(r) * 0.0f);
    T w = A::max(A::sub(h2, r2), z0);
    w = A::mul(A::mul(w, w), w);
    acc = A::add(acc, live ? w : z0);
  }
  out[i] = A::to_f32(acc);
}

// The first loop probe (replaces scripts/loop_probe.py make_kernel, like
// probes.cu, which describes the variants and the `b * zero` index). Each
// thread owns one element (p, l) of the (pt, bl) output, in blocks of 128,
// and takes the candidate blocks one by one: a round is a chain from the
// 2-byte load of its desc entry (a uniform __ldg, one broadcast load a warp)
// to the three candidate loads at that offset to the add.
//   kDynTrip: n = desc[rounds]; otherwise n = kRounds, a compile-time constant.
//   kDynLoad: off_b = desc[b] * 128; otherwise off_b = 0.
//   kUnroll:  blocks per loop iteration (V4: 2).
constexpr int kProbeBaselineBlock = 128;

template <bool kDynTrip, bool kDynLoad, int kUnroll, bool kForce, int kRounds>
__global__ void __launch_bounds__(kProbeBaselineBlock)
    loop_probe_baseline_kernel(const short* __restrict__ desc,
                               const float* __restrict__ t,
                               const float* __restrict__ cand, int cap, int pt,
                               int bl, int rounds, int zero,
                               float* __restrict__ out) {
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

template <bool kDynTrip, bool kDynLoad, int kUnroll, bool kForce, int kRounds>
void launch_loop_probe_baseline(const short* desc, const float* t, const float* cand,
                                int cap, int pt, int bl, int rounds, float* out,
                                cudaStream_t stream) {
  const int blocks = (pt * bl + kProbeBaselineBlock - 1) / kProbeBaselineBlock;
  loop_probe_baseline_kernel<kDynTrip, kDynLoad, kUnroll, kForce, kRounds>
      <<<blocks, kProbeBaselineBlock, 0, stream>>>(desc, t, cand, cap, pt, bl, rounds, 0,
                                                   out);
}

template <bool kDynLoad>
cudaError_t launch_static_trip_baseline(const short* desc, const float* t,
                                        const float* cand, int cap, int pt, int bl,
                                        int rounds, float* out, cudaStream_t stream) {
  switch (rounds) {  // the instantiated trip counts
    case 64:
      launch_loop_probe_baseline<false, kDynLoad, 1, false, 64>(desc, t, cand, cap, pt, bl,
                                                                rounds, out, stream);
      return cudaSuccess;
    case 4096:
      launch_loop_probe_baseline<false, kDynLoad, 1, false, 4096>(desc, t, cand, cap, pt, bl,
                                                                  rounds, out, stream);
      return cudaSuccess;
    case 16384:
      launch_loop_probe_baseline<false, kDynLoad, 1, false, 16384>(desc, t, cand, cap, pt,
                                                                   bl, rounds, out, stream);
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpusph

extern "C" int tpusph_density_baseline(const float* x, const float* y, const float* z,
                                       const int* key, const int* starts, int n,
                                       int C, int nc, float h2, float scale,
                                       float* rho, cudaStream_t stream) {
  if (n > 0) {
    tpusph::density_kernel<<<tpusph::num_blocks(n), tpusph::kBlock, 0, stream>>>(
        x, y, z, key, starts, n, C, nc, h2, scale, rho);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusph_force_baseline(const float* x, const float* y, const float* z,
                                     const float* vx, const float* vy,
                                     const float* vz, const float* rho,
                                     const float* p, const int* key,
                                     const int* starts, int n, int C, int nc,
                                     float h, float h2, float eps, float m,
                                     float vk, float mu, float* f,
                                     cudaStream_t stream) {
  if (n > 0) {
    tpusph::force_kernel<<<tpusph::num_blocks(n), tpusph::kBlock, 0, stream>>>(
        x, y, z, vx, vy, vz, rho, p, key, starts, n, C, nc, h, h2, eps, m, vk,
        mu, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusph_qrank_baseline(const int* key_sorted, int n, const int* queries,
                                     int nq, int num_cells, int* ranks,
                                     cudaStream_t stream) {
  if (nq > 0) {
    tpusph::qrank_kernel<<<tpusph::num_blocks(nq), tpusph::kBlock, 0, stream>>>(
        key_sorted, n, queries, nq, num_cells, ranks);
  }
  return static_cast<int>(cudaGetLastError());
}

// t: (>= pt, 4), c: (8, 128), both f32 (bf16 = 0) or bf16 (bf16 = 1);
// out: f32 (pt, 128).
extern "C" int tpusph_density_mix_baseline(const void* t, const void* c, int pt,
                                           int rounds, int bf16, float* out,
                                           cudaStream_t stream) {
  using namespace tpusph;
  if (pt > 0) {
    const int g = (pt * 128 + kMixBaselineBlock - 1) / kMixBaselineBlock;
    if (bf16) {
      density_mix_baseline_kernel<BF16Ops><<<g, kMixBaselineBlock, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(c),
          pt, rounds, 0, out);
    } else {
      density_mix_baseline_kernel<F32Ops><<<g, kMixBaselineBlock, 0, stream>>>(
          static_cast<const float*>(t), static_cast<const float*>(c), pt, rounds, 0,
          out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// desc: int16 (rounds + 8); t: f32 (>= pt, 4); cand: f32 (8, cap);
// out: f32 (pt, bl); variant 0-5 is V0-V5 of loop_probe.py. V0 and V1 take
// their trip count at compile time and accept rounds in {64, 4096, 16384}.
extern "C" int tpusph_loop_probe_baseline(const short* desc, const float* t,
                                          const float* cand, int cap, int pt, int bl,
                                          int rounds, int variant, float* out,
                                          cudaStream_t stream) {
  using namespace tpusph;
  if (pt <= 0 || bl <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0:  // static trip, static loads
      err = launch_static_trip_baseline<false>(desc, t, cand, cap, pt, bl, rounds, out,
                                               stream);
      break;
    case 1:  // static trip, desc-table loads
      err = launch_static_trip_baseline<true>(desc, t, cand, cap, pt, bl, rounds, out,
                                              stream);
      break;
    case 2:  // desc-table trip, static loads
      launch_loop_probe_baseline<true, false, 1, false, 0>(desc, t, cand, cap, pt, bl, rounds,
                                                           out, stream);
      break;
    case 3:  // desc-table trip and loads
      launch_loop_probe_baseline<true, true, 1, false, 0>(desc, t, cand, cap, pt, bl, rounds,
                                                          out, stream);
      break;
    case 4:  // V3 unrolled x2
      launch_loop_probe_baseline<true, true, 2, false, 0>(desc, t, cand, cap, pt, bl, rounds,
                                                          out, stream);
      break;
    case 5:  // V3 with the force op mix
      launch_loop_probe_baseline<true, true, 1, true, 0>(desc, t, cand, cap, pt, bl, rounds,
                                                         out, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
