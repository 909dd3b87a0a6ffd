// Density and force passes of one SPH step over cell-sorted particles, as
// tile kernels: a block owns a tile of consecutive sorted targets; the
// density stages the stencil windows in shared memory where they are
// dense and reads device memory where they are sparse; the force reads
// packed 16-byte rows from device memory.
//
// Replaces tpusph/pallas/fused.py:
//   density_pallas / _density_kernel -> tpusph_density (density_tile_kernel)
//   force_pallas   / _force_kernel   -> tpusph_force_pack (force_tile_kernel_pack),
//                                        then tpusph_force (force_tile_kernel)
// The density's first design, one thread per target gathering straight
// from device memory, stays in sph_baseline.cu as the reference this
// density is held to bit for bit.
//
// The candidates. For neighbour column (dy, dz), off = dy*C + dz*C*C, a
// target with key k takes the sorted rows starts[lo] .. starts[hi] with
//   lo = clip(k + off - 1, 0, nc),  hi = clip(k + off + 2, lo, nc),
// exactly the key-mask hit set of the JAX tile pass (engine/step.py
// _density_pass_sorted); the 9 windows of one target are disjoint, so no
// mask is needed. hi <= nc keeps the padding rows (key nc, sorted to the
// end) out of every window.
//
// The design. A block owns kTile consecutive sorted targets, one thread
// each, and loads each thread's 18 starts entries at once, before any
// pair. Keys are sorted, so in each column both ends of the windows
// [b_i, e_i) are non-decreasing in i, and the block needs one ascending
// sweep of the union of its windows per column. A density block whose live
// targets average at least kStageMin candidates walks (column, chunk)
// pairs, dz outer and dy inner as the TPU kernel orders them: a chunk
// starts at the smallest max(b_i, cursor) over the threads with rows left
// (a warp __reduce_min_sync plus one shared step; rows that no target of
// the tile needs, where a tile crosses an x-row or a z-plane, are skipped)
// and stops at the block's last window end in the column or where its
// stage is full. A stage of the 2-stage ring in shared memory holds x, y,
// z of up to kChunk row slots in up to kPieces chunks, of several columns
// where windows are short, so a barrier serves many chunks; stage j+1 is
// copied while stage j is summed. Each thread sums its window's part of
// each chunk in ascending row order. A sparser density block, and every
// force block, walks its 9 windows from device memory as the first design
// does: there the loads hit L1, since neighbouring targets share most of
// their windows, and staging costs more instructions than it saves
// (PERF.md: the force was slower staged at every state measured).
// Either way each target adds its pairs in the first design's order, and
// the density with its per-pair expressions, so the density equals
// sph_baseline.cu's bit for bit. kernels/fused.py::chunk_walk is the staged
// walk in plain PyTorch.
//
// The force's rows. A pass of force_tile_kernel_pack, one thread a row,
// first packs the eight fields into two float4 rows, r0 = (x, y, z,
// 1/(2 rho)) and r1 = (vx, vy, vz, p). The force's walk is bound by its
// load instructions and their L1 wavefronts, not by bytes (the lanes of a
// warp sit in 2-3 cells, so each load of a candidate's field costs up to
// 2-3 wavefronts): reading packed rows, a candidate is one 16-byte load
// where it was three 4-byte ones, and a pair within h one more where it was
// five, and the pair takes 1/(2 rho_j) from its row, computed once a
// particle, where it took an IEEE divide once a pair. The packing is a
// fixed pass over n rows (32 bytes in and out a row); the saving grows
// with the candidates walked, so every state takes it. The density keeps
// its three field arrays: it reads only x, y, z, its dense blocks copy
// them into shared memory a field at a time (4 rows in 16 bytes), and a
// fourth lane would add a quarter to every copy and every staged slot.
//
// The shapes (kTile, kChunk, kStageMin) are the fastest mean over steps 0,
// 20, 50 and 100 of 262,144 grid init in a sweep of T 64-256, S 32-1024
// and the threshold on an H100 (PERF.md).
//
// Copies: cp.async of 16 bytes (4 rows of one field), issued by all
// threads in slot order (coalesced), one commit group per stage. A chunk
// is staged from its start aligned down to 4 rows to its stop aligned up;
// where x, y, z do not all start on 16 bytes or n is not a multiple of 4,
// the block copies the chunk's rows 4 bytes at a time into the same slots
// instead. cp.async rather than the Tensor Memory Accelerator's bulk
// copies: a thread's own copies are complete after its wait_group, with no
// mbarrier phases to track; a bulk copy would move the same rows from one
// issuing thread, and is later work.
//
// Barriers. Every thread of a block, sentinel rows (key >= nc) and rows
// past n included, reaches every barrier: those rows get empty windows and
// stay in the block. The sweep's bounds come from block reductions, so they
// are block-uniform; only the per-thread inner loop differs. Per stage: a
// barrier after the copies' wait, so every warp sees the whole stage, and
// one after the sums, so no warp copies into a stage that another warp
// still reads.
//
// No capacity: every window is walked to its end, so nothing can overflow.
// No atomics and no cross-block step in the sums: results repeat bit for
// bit. The force's walk counter (below) is the one place with atomics: it
// counts, and touches no sum.
// Distances use the exact displacement form dx*dx + dy*dy + dz*dz in fp32
// on the CUDA cores; the |t|^2 + |c|^2 - 2 t.c identity on tensor cores
// loses the 1e-4 density budget to cancellation (fused.py:30-33).
//
// What bounds them on the H100 (3.35 TB/s, 67 TFLOP/s fp32), at 262,144
// particles (chip_smoke.py phase 3 computes both bounds at each state):
// density reads the key and 3 fields and writes 1 (5.2 MB) plus the starts
// entries it uses, ~2 us; it does 9 flops a candidate and 4 more a pair
// within h, 1e8-5e8 flops from step 20 to 100. Force moves 12 rows of 4
// bytes a particle (12.6 MB) plus the starts, ~4 us, and does 9 flops a
// candidate and 32 a pair within h; operations bind it by step 100 (6e7
// candidates). Both run at a few percent of these bounds: they are bound
// by instruction throughput (loop and window bookkeeping, divergence)
// and by their load instructions' latency and L1 wavefronts, which the
// force's packed rows cut to one 16-byte load a candidate and one a pair.
// What the design does about the first design's costs (one thread a
// target):
//   - load latency: all starts entries are loaded up front, and dense
//     density blocks read their candidates from shared memory, staged a
//     stage ahead;
//   - per-window overhead and divergence: in a dense block a warp's lanes
//     read the same staged rows, and one barrier serves the chunks of
//     several columns;
//   - divides: the force takes 1/(2 rho_j) once a particle, in the
//     packing pass, as the TPU kernel does (fused.py:34-35), and no divide
//     a pair (the first design took three); r comes from rsqrt, a few ulps
//     from the first design's sqrt;
//   - loads: the force reads a candidate as one 16-byte row and a pair as
//     one more (the first design, three 4-byte loads a candidate and five
//     more a pair).

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace tpusph {
namespace {

constexpr int kColumns = 9;
constexpr unsigned kFullMask = 0xffffffffu;

// Targets a block, one thread each (both kernels); a power of 2 of whole
// warps.
constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
// Row slots a density stage holds (a multiple of 4: whole 16-byte copies).
constexpr int kChunk = 1024;
// A density block stages when its live targets average at least this many
// candidates.
constexpr int kStageMin = 96;
// Chunks a stage holds at most. A chunk is staged from its start aligned
// down to 4 rows to its stop aligned up, so it takes up to 6 slots more
// than its rows.
constexpr int kPieces = 16;
// Fields a stage holds per row: x, y, z.
constexpr int kStaged = 3;
// Warps an SM should hold (of its 64): as many as a force kernel of one
// thread a target reaches, so that a block that reads device memory hides
// its latency as well; caps the registers a thread may use at 48.
constexpr int kWarpsPerSm = 40;
constexpr int kBlocksPerSm = kWarpsPerSm * 32 / kTile;

template <int F>
struct Fields {
  const float* p[F];
};

// 16 bytes (4 rows of one field) from device memory into shared memory,
// bypassing L1: a staged row is read from shared memory only.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// One row of one field, for fields off a 16-byte boundary.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Each thread's 9 windows [begin, end) of sorted rows.
struct Windows {
  int begin[kColumns][kTile];
  int end[kColumns][kTile];
};

// This thread's 9 windows into `w`; returns its candidate count. Dead
// threads (sentinel rows, rows past n) get empty windows. A thread reads
// back only its own entries, so no barrier is needed here.
__device__ __forceinline__ unsigned load_windows(Windows& w, const int* __restrict__ starts,
                                                 int k, bool live, int C, int nc) {
  const int t = threadIdx.x;
  unsigned rows = 0;
#pragma unroll
  for (int c = 0; c < kColumns; ++c) {
    const int off = (c % 3 - 1) * C + (c / 3 - 1) * C * C;
    const int lo = min(max(k + off - 1, 0), nc);
    const int hi = min(max(k + off + 2, lo), nc);
    const int b = live ? __ldg(starts + lo) : 0;
    const int e = live ? __ldg(starts + hi) : 0;
    w.begin[c][t] = b;
    w.end[c][t] = e;
    rows += e - b;
  }
  return rows;
}

// One chunk of the sweep: rows [start, stop) of `column`. column ==
// kColumns marks the end of the sweep.
struct Chunk {
  int column;
  int start;
  int stop;
};

// Shared memory of a density block: the ring of staged rows with each
// stage's chunks (column, start, stop, slot of row start) and their count,
// each thread's 9 windows, the block's first begin and last end of each
// column (and per warp, on the way there), and the scratch of the
// per-chunk block minimum (two buffers, in turns).
struct DensitySmem {
  float ring[2][kStaged][kChunk];
  int4 piece[2][kPieces];
  int pieces[2];
  Windows w;
  int warp_first[kColumns][kWarps];
  int warp_last[kColumns][kWarps];
  int first[kColumns];
  int last[kColumns];
  int red[2][kWarps];
  unsigned warp_rows[kWarps];
  unsigned warp_live[kWarps];
  int staged;  // the block stages its windows (else it reads device memory)
};
static_assert(sizeof(DensitySmem) <= 48 * 1024,
              "a launch without cudaFuncSetAttribute takes at most 48 KB");

// After load_windows: the block's smallest begin and largest end of the
// non-empty windows of each column, and whether the block stages (its live
// targets have at least kStageMin window rows each on average). Ends with
// a barrier.
__device__ __forceinline__ void plan_sweep(DensitySmem& sm, unsigned rows, bool live) {
  const int t = threadIdx.x;
  rows = __reduce_add_sync(kFullMask, rows);
  const unsigned lives = __reduce_add_sync(kFullMask, live ? 1u : 0u);
  if ((t & 31) == 0) {
    sm.warp_rows[t >> 5] = rows;
    sm.warp_live[t >> 5] = lives;
  }
#pragma unroll
  for (int c = 0; c < kColumns; ++c) {
    const int b = sm.w.begin[c][t];
    const int e = sm.w.end[c][t];
    const bool has = e > b;
    const int lo = __reduce_min_sync(kFullMask, has ? b : INT_MAX);
    const int hi = __reduce_max_sync(kFullMask, has ? e : INT_MIN);
    if ((t & 31) == 0) {
      sm.warp_first[c][t >> 5] = lo;
      sm.warp_last[c][t >> 5] = hi;
    }
  }
  __syncthreads();
  if (t < kColumns) {
    int lo = INT_MAX;
    int hi = INT_MIN;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, sm.warp_first[t][w]);
      hi = max(hi, sm.warp_last[t][w]);
    }
    sm.first[t] = lo;
    sm.last[t] = hi;
  }
  if (t == kColumns) {
    unsigned long long total = 0;
    unsigned long long targets = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += sm.warp_rows[w];
      targets += sm.warp_live[w];
    }
    sm.staged = targets > 0 && total >= targets * kStageMin;
  }
  __syncthreads();
}

// The walk over (column, chunk); every thread of the block calls next()
// together and gets the same chunk.
struct Sweep {
  DensitySmem& sm;
  int column = 0;
  int cursor = -1;  // end of the last chunk of `column`; -1 before its first
  int last = 0;     // the block's last window end in `column`
  int parity = 0;

  __device__ explicit Sweep(DensitySmem& s) : sm(s) {}

  // The next chunk whose slots, from its start aligned down to 4 rows,
  // fit in `room` slots (a multiple of 4, at least 4).
  __device__ Chunk next(int room) {
    const int t = threadIdx.x;
    while (column < kColumns) {
      int start;
      if (cursor < 0) {
        start = sm.first[column];
        last = sm.last[column];
        if (start == INT_MAX) {  // no target of the tile has this column
          ++column;
          continue;
        }
      } else if (cursor >= last) {
        ++column;
        cursor = -1;
        continue;
      } else {
        // The smallest row at or past the cursor that a thread still needs.
        // `last` > cursor, so the thread with that end has rows left.
        const int from = max(sm.w.begin[column][t], cursor);
        int v = __reduce_min_sync(kFullMask, sm.w.end[column][t] > from ? from : INT_MAX);
        if ((t & 31) == 0) sm.red[parity][t >> 5] = v;
        __syncthreads();
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v = min(v, sm.red[parity][w]);
        parity ^= 1;
        start = v;
      }
      cursor = min((start & ~3) + room, last);
      return {column, start, cursor};
    }
    return {kColumns, 0, 0};
  }

  // Fill stage `s` with the next chunks, up to kChunk slots and kPieces
  // chunks, issuing their copies as one commit group. With `quads`, 16
  // bytes (4 rows of a field) a copy, thread t taking the stage's slots
  // 4t .. 4t + 3, 4(t + kTile) ..; else the chunk's rows one at a time.
  // Returns the slots filled, 0 when the sweep is over.
  __device__ int fill(int s, const Fields<kStaged>& src, bool quads) {
    const int t = threadIdx.x;
    int used = 0;
    int count = 0;
    while (count < kPieces && used < kChunk) {
      const Chunk c = next(kChunk - used);
      if (c.column == kColumns) break;
      const int from = c.start & ~3;
      if (t == 0) sm.piece[s][count] = make_int4(c.column, c.start, c.stop, used + c.start - from);
      const int slots = ((c.stop - from + 3) >> 2) << 2;
#pragma unroll
      for (int f = 0; f < kStaged; ++f) {
        float* dst = sm.ring[s][f] + used;  // the slot of row `from`
        if (quads) {
          for (int q = (t - (used >> 2)) & (kTile - 1); 4 * q < slots; q += kTile) {
            copy_async16(dst + 4 * q, src.p[f] + from + 4 * q);
          }
        } else {
          for (int j = c.start + t; j < c.stop; j += kTile) {
            copy_async4(dst + (j - from), src.p[f] + j);
          }
        }
      }
      used += slots;
      ++count;
    }
    if (t == 0) sm.pieces[s] = count;
    copy_commit();
    return used;
  }
};

// Raw density m * d_coeff * sum_j (h^2 - r^2)^3 over candidates with
// r^2 <= h^2, the target itself included (poly6 has no self-exclusion).
// Sentinel rows (key >= nc) write 0. `quads`: x, y, z start on 16 bytes
// and n is a multiple of 4, so stages fill by 16-byte copies.
__global__ void __launch_bounds__(kTile, kBlocksPerSm)
    density_tile_kernel(Fields<kStaged> xyz, const int* __restrict__ key,
                        const int* __restrict__ starts, int n, int C, int nc,
                        float h2, float scale, bool quads, float* __restrict__ rho) {
  __shared__ DensitySmem sm;
  const int t = threadIdx.x;
  const int i = blockIdx.x * kTile + t;
  const int k = i < n ? key[i] : nc;
  const bool live = k < nc;
  const float xi = live ? xyz.p[0][i] : 0.0f;
  const float yi = live ? xyz.p[1][i] : 0.0f;
  const float zi = live ? xyz.p[2][i] : 0.0f;
  plan_sweep(sm, load_windows(sm.w, starts, k, live, C, nc), live);
  float acc = 0.0f;
  const auto add = [&](float xj, float yj, float zj) {
    const float ddx = xi - xj;
    const float ddy = yi - yj;
    const float ddz = zi - zj;
    const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
    if (r2 <= h2) {
      const float d = h2 - r2;
      acc += d * d * d;
    }
  };
  if (sm.staged) {
    Sweep sweep(sm);
    int used = sweep.fill(0, xyz, quads);
    int buf = 0;
    while (used > 0) {
      const int next = sweep.fill(buf ^ 1, xyz, quads);
      if (next > 0) {
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();  // every thread's copies of this stage have landed
      const int count = sm.pieces[buf];
      const float(&stage)[kStaged][kChunk] = sm.ring[buf];
      for (int q = 0; q < count; ++q) {
        const int4 pc = sm.piece[buf][q];  // column, start, stop, slot of start
        const int lo = max(sm.w.begin[pc.x][t], pc.y) - pc.y + pc.w;
        const int hi = min(sm.w.end[pc.x][t], pc.z) - pc.y + pc.w;
#pragma unroll 4
        for (int j = lo; j < hi; ++j) add(stage[0][j], stage[1][j], stage[2][j]);
      }
      __syncthreads();  // no warp still reads the stage the next fill writes
      used = next;
      buf ^= 1;
    }
  } else {
    for (int c = 0; c < kColumns; ++c) {
      const int hi = sm.w.end[c][t];
      for (int j = sm.w.begin[c][t]; j < hi; ++j) {
        add(__ldg(xyz.p[0] + j), __ldg(xyz.p[1] + j), __ldg(xyz.p[2] + j));
      }
    }
  }
  if (i < n) rho[i] = live ? scale * acc : 0.0f;
}

// The block's part of the force's walk counter: its threads' candidates
// `rows` and pressured targets, summed by warp and then by block, added to
// walk[0] and walk[1], and its candidates as a max into walk[2].
__device__ __forceinline__ void count_walk(unsigned rows, bool pressured,
                                           unsigned long long* __restrict__ walk) {
  __shared__ unsigned warp_rows[kWarps];
  __shared__ unsigned warp_pressured[kWarps];
  const int t = threadIdx.x;
  rows = __reduce_add_sync(kFullMask, rows);
  const unsigned live = __reduce_add_sync(kFullMask, pressured ? 1u : 0u);
  if ((t & 31) == 0) {
    warp_rows[t >> 5] = rows;
    warp_pressured[t >> 5] = live;
  }
  __syncthreads();
  if (t == 0) {
    unsigned long long total = 0;
    unsigned long long targets = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += warp_rows[w];
      targets += warp_pressured[w];
    }
    atomicAdd(walk, total);
    atomicAdd(walk + 1, targets);
    atomicMax(walk + 2, total);
  }
}

// The force's packed rows, one thread a row over the n sorted rows:
//   r0[j] = (x_j, y_j, z_j, 1/(2 rho_j)),  r1[j] = (vx_j, vy_j, vz_j, p_j).
// 1/(2 rho_j) is the expression a pair took before the rows were packed, so
// it is the same float. Every row is written, padding rows included (their
// 1/(2 rho) may be anything: no window holds them).
__global__ void __launch_bounds__(kBlock)
    force_tile_kernel_pack(Fields<8> fs, int n, float4* __restrict__ r0,
                           float4* __restrict__ r1) {
  const int j = blockIdx.x * kBlock + threadIdx.x;
  if (j >= n) return;
  r0[j] = make_float4(fs.p[0][j], fs.p[1][j], fs.p[2][j], 1.0f / (2.0f * fs.p[6][j]));
  r1[j] = make_float4(fs.p[3][j], fs.p[4][j], fs.p[5][j], fs.p[7][j]);
}

// Pressure plus viscosity force on each sorted target, the per-pair
// arithmetic of physics/kernels.py pair_force with both of its guards:
//   pressure  (r^2 <= h^2, r >= eps): -m (p_i + p_j) / (2 rho_j) * grad,
//             grad = disp * (-vk (h - r)^2 / r)
//   viscosity (r <= h,     r >= eps): mu m vk (h - r) / rho_j * (v_j - v_i)
// r >= eps drops the self pair. Reads the packed rows of
// force_tile_kernel_pack: a candidate is one 16-byte load of r0[j], a pair
// within h one more of r1[j], and a = 1/(2 rho_j) comes with the position.
// Output is field-major f[3][n]; sentinel rows write 0. A pair takes
// r = r^2 * rsqrt(r^2), a few ulps from the exact form. r^2 = 0 gives
// r = NaN, which fails r >= eps as the self pair must.
//
// With Count, the walk counter `walk` (int64[3], zeroed by the caller)
// takes, over the launch, the candidates the targets walk (their 9
// windows' lengths, from load_windows), the live targets with p_i > 0, and
// as a max the candidates of the heaviest block: one warp and block
// reduction after the windows are loaded, then one atomic of each from the
// block's first thread. Nothing is added a pair, and the sums are those of
// the kernel without Count, bit for bit.
template <bool Count>
__global__ void __launch_bounds__(kTile, kBlocksPerSm)
    force_tile_kernel(const float4* __restrict__ r0, const float4* __restrict__ r1,
                      const int* __restrict__ key, const int* __restrict__ starts, int n,
                      int C, int nc, float h, float h2, float eps, float m, float vk,
                      float mu, float* __restrict__ f, unsigned long long* __restrict__ walk) {
  __shared__ Windows w;
  const int t = threadIdx.x;
  const int i = blockIdx.x * kTile + t;
  const int k = i < n ? key[i] : nc;
  const bool live = k < nc;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 own = live ? r0[i] : zero;
  const float4 vown = live ? r1[i] : zero;
  const float xi = own.x;
  const float yi = own.y;
  const float zi = own.z;
  const float vxi = vown.x;
  const float vyi = vown.y;
  const float vzi = vown.z;
  const float pi = vown.w;
  const float visc_c = 2.0f * ((mu * m) * vk);
  const unsigned rows = load_windows(w, starts, k, live, C, nc);
  if constexpr (Count) count_walk(rows, live && pi > 0.0f, walk);
  float ax = 0.0f;
  float ay = 0.0f;
  float az = 0.0f;
  for (int c = 0; c < kColumns; ++c) {
    const int end = w.end[c][t];
    for (int j = w.begin[c][t]; j < end; ++j) {
      const float4 cj = __ldg(r0 + j);
      const float ddx = xi - cj.x;
      const float ddy = yi - cj.y;
      const float ddz = zi - cj.z;
      const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
      // Past r^2 <= h^2 the pressure term is off, and the viscosity term
      // is off too or, at sqrt rounding to r == h, exactly 0.
      if (r2 > h2) continue;
      const float rinv = rsqrtf(r2);
      const float r = r2 * rinv;
      if (!(r >= eps)) continue;  // self pair (r^2 = 0 gives NaN)
      const float a = cj.w;  // 1/(2 rho_j)
      const float4 vj = __ldg(r1 + j);
      const float hr = h - r;
      const float grad = (-vk) * (hr * hr) * rinv;
      const float coef = (-m) * (pi * a + vj.w * a);
      float fx = coef * (ddx * grad);
      float fy = coef * (ddy * grad);
      float fz = coef * (ddz * grad);
      if (r <= h) {
        const float visc = visc_c * hr * a;
        fx += visc * (vj.x - vxi);
        fy += visc * (vj.y - vyi);
        fz += visc * (vj.z - vzi);
      }
      ax += fx;
      ay += fy;
      az += fz;
    }
  }
  if (i < n) {
    f[i] = ax;
    f[n + i] = ay;
    f[2 * n + i] = az;
  }
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace
}  // namespace tpusph

extern "C" int tpusph_density(const float* x, const float* y, const float* z,
                              const int* key, const int* starts, int n, int C,
                              int nc, float h2, float scale, float* rho,
                              cudaStream_t stream) {
  using namespace tpusph;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool quads = n % 4 == 0 && ((reinterpret_cast<std::uintptr_t>(x) |
                                     reinterpret_cast<std::uintptr_t>(y) |
                                     reinterpret_cast<std::uintptr_t>(z)) & 15) == 0;
  density_tile_kernel<<<tiles(n), kTile, 0, stream>>>(Fields<kStaged>{{x, y, z}}, key, starts,
                                                      n, C, nc, h2, scale, quads, rho);
  return static_cast<int>(cudaGetLastError());
}

// The force's packed rows r0, r1 (float4[n] each) from the eight fields;
// cudaErrorMisalignedAddress, and nothing launched, where r0 or r1 is off
// a 16-byte boundary.
extern "C" int tpusph_force_pack(const float* x, const float* y, const float* z,
                                 const float* vx, const float* vy, const float* vz,
                                 const float* rho, const float* p, int n, float* r0,
                                 float* r1, cudaStream_t stream) {
  using namespace tpusph;
  if ((reinterpret_cast<std::uintptr_t>(r0) | reinterpret_cast<std::uintptr_t>(r1)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Fields<8> fs{{x, y, z, vx, vy, vz, rho, p}};
  force_tile_kernel_pack<<<num_blocks(n), kBlock, 0, stream>>>(
      fs, n, reinterpret_cast<float4*>(r0), reinterpret_cast<float4*>(r1));
  return static_cast<int>(cudaGetLastError());
}

// r0, r1: the packed rows of tpusph_force_pack. `walk`: the walk counter
// (int64[3], zeroed by the caller), or null to count nothing.
extern "C" int tpusph_force(const float* r0, const float* r1, const int* key,
                            const int* starts, int n, int C, int nc, float h, float h2,
                            float eps, float m, float vk, float mu, float* f,
                            unsigned long long* walk, cudaStream_t stream) {
  using namespace tpusph;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const float4* rows = reinterpret_cast<const float4*>(r0);
  const float4* vels = reinterpret_cast<const float4*>(r1);
  if (walk == nullptr) {
    force_tile_kernel<false><<<tiles(n), kTile, 0, stream>>>(rows, vels, key, starts, n, C, nc,
                                                             h, h2, eps, m, vk, mu, f, walk);
  } else {
    force_tile_kernel<true><<<tiles(n), kTile, 0, stream>>>(rows, vels, key, starts, n, C, nc,
                                                            h, h2, eps, m, vk, mu, f, walk);
  }
  return static_cast<int>(cudaGetLastError());
}
