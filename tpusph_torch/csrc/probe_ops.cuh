// Arithmetic of the density-mix probe (probes.cu) in its dtype.
#pragma once

#include <cuda_bf16.h>

namespace tpusph {

// Arithmetic in the probe's dtype. float leaves contraction to nvcc, as in
// sph.cu; bf16 uses the _rn intrinsics, which nvcc never contracts into an
// FMA, so every op rounds to bf16 as in the plain PyTorch version.
struct F32Ops {
  using T = float;
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
  static __device__ __forceinline__ T max(T a, T b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float to_f32(T a) { return a; }
  static __device__ __forceinline__ T from_f32(float a) { return a; }
};

struct BF16Ops {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd_rn(a, b); }
  static __device__ __forceinline__ T mul(T a, T b) { return __hmul_rn(a, b); }
  static __device__ __forceinline__ T max(T a, T b) { return __hmax(a, b); }
  static __device__ __forceinline__ float to_f32(T a) { return __bfloat162float(a); }
  static __device__ __forceinline__ T from_f32(float a) { return __float2bfloat16_rn(a); }
};

}  // namespace tpusph
