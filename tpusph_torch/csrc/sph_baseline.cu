// The first design of the density kernel, kept as the reference that the
// tiled density (sph.cu, tpusph_density) is held to bit for bit: a block
// that stages its windows and a block that reads device memory must both
// give each target the sums this kernel gives, in the same order with the
// same per-pair expressions. The GPU tests and chip_smoke.py phase 3 compare
// the two at the main path's states; the engine never launches this one.
//
// Replaces tpusph/pallas/fused.py, like sph.cu:
//   density_pallas / _density_kernel -> tpusph_density_baseline
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
// Bound by load latency (each candidate is 3 dependent __ldg gathers after
// two loads of the starts table) and by warp divergence, where the 9
// window lengths differ within a warp; sph.cu says what the tiled design
// does about both.

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
