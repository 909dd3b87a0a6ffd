// Shared launch constants of the tpusph_torch kernels.
#pragma once

#include <cuda_runtime.h>

namespace tpusph {

// Threads per block for the one-thread-per-item kernels.
constexpr int kBlock = 256;

inline int num_blocks(int items) { return (items + kBlock - 1) / kBlock; }

}  // namespace tpusph
