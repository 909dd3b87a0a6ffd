// Density and force passes of one SPH step over cell-sorted particles.
//
// Replaces tpusph/pallas/fused.py:
//   density_pallas / _density_kernel -> tpusph_density
//   force_pallas   / _force_kernel   -> tpusph_force
//
// The TPU kernels DMA each tile's stencil windows into VMEM and scan them
// in 128-lane blocks, with a key-difference mask that assigns each pair to
// one window, because the TPU cannot gather cheaply from the starts table
// (fused.py _rank_left explains why). A GPU can, so each thread here owns
// one sorted target and walks its own 9 windows straight from the starts
// table: for neighbour column (dy, dz), off = dy*C + dz*C*C, the candidates
// are the sorted rows starts[lo] .. starts[hi] with
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
// What bounds them on the H100: at 262,144 particles a target has about 40
// candidates, so a pass is ~1e7 pairs, ~10 flops each for density and ~40
// for force (with one sqrt and two divides): far below the card's fp32
// rate. The candidate loads are gathers, but consecutive targets of a warp
// sit in neighbouring cells and share most of their windows, so the loads
// hit L1/L2, and device memory sees about one pass over the sorted fields.
// The kernels are therefore bound by load latency and by warp divergence
// where window lengths differ within a warp. One thread per target is the
// simplest design that keeps all SMs busy; staging shared windows in
// shared memory is later work.

#include "common.cuh"

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

}  // namespace
}  // namespace tpusph

extern "C" int tpusph_density(const float* x, const float* y, const float* z,
                              const int* key, const int* starts, int n, int C,
                              int nc, float h2, float scale, float* rho,
                              cudaStream_t stream) {
  if (n > 0) {
    tpusph::density_kernel<<<tpusph::num_blocks(n), tpusph::kBlock, 0, stream>>>(
        x, y, z, key, starts, n, C, nc, h2, scale, rho);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusph_force(const float* x, const float* y, const float* z,
                            const float* vx, const float* vy, const float* vz,
                            const float* rho, const float* p, const int* key,
                            const int* starts, int n, int C, int nc, float h,
                            float h2, float eps, float m, float vk, float mu,
                            float* f, cudaStream_t stream) {
  if (n > 0) {
    tpusph::force_kernel<<<tpusph::num_blocks(n), tpusph::kBlock, 0, stream>>>(
        x, y, z, vx, vy, vz, rho, p, key, starts, n, C, nc, h, h2, eps, m, vk,
        mu, f);
  }
  return static_cast<int>(cudaGetLastError());
}
