// Shared pieces of the port's CSR row reductions (K1, K2, K3).
//
// The receiver-sorted edges of a row are cut into consecutive segments of
// at most ROW_SEGMENT edges (src/repro_torch/kernels/csr.py builds the
// tables).  The tables list only the rows that own an edge (row_ids), so a
// color's edge subset costs tables of its own size.  Every kernel walks the
// segments through tile tables (csr.py TileTables): one block a tile stages
// the tile's terms in shared memory, coalesced, then one thread adds each
// segment (K3: each segment and column) in edge order from 0.  A row of one
// segment is written in that launch; a row of two or more leaves partial
// sums, and a second launch adds them in segment order.  K1 at D >= 2
// streams runs of segments (csr.py ColumnItems) through an asynchronous
// ring of gathered rows (cp.async.bulk and mbarriers), one warp a run and
// column slice, each lane adding its columns of each segment in edge order
// (gas_gather_combine.cu); K3 at D > kThreads keeps one warp a segment
// (lanes over the columns).
// Each add is one correctly rounded add and each product one correctly
// rounded multiply (__fadd_rn / __fmul_rn keep nvcc from contracting them
// into an FMA).  That is the order and rounding of the plain PyTorch
// versions (sequential index_add_ over segments, then over rows), so each
// kernel's output equals its plain version bit for bit, and an engine on
// the card takes the same schedule as on the CPU.  A sum that starts from
// +0 is never -0 (x + -0 = x, +0 + -0 = +0, x + -x = +0), so adding 0 to it
// changes no bit, and terms that are exact zeros can be left out without
// changing any bit of it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kTileBatch = 4;        // edges a thread keeps in flight when staging
constexpr int kCombineChunk = 2048;  // partials a D = 1 combine block stages at once

// The work item (segment) this warp owns (warp-uniform), or -1 past the end.
__device__ __forceinline__ int64_t warp_item(int64_t n_items) {
  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  return item < n_items ? item : -1;
}

// The output element this thread owns, or -1 past the end.
__device__ __forceinline__ int64_t thread_item(int64_t n_items) {
  const int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  return item < n_items ? item : -1;
}

// One correctly rounded add / multiply, never contracted into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// acc + buf[0] + ... + buf[n - 1], added in order by one thread; loads run
// ahead of the chain of adds.
template <typename T>
__device__ __forceinline__ T serial_sum(const T* buf, int n, T acc) {
  int i = 0;
#pragma unroll 2
  for (; i + 8 <= n; i += 8) {
    T v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = buf[i + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = add_rn(acc, v[j]);
  }
  for (; i < n; ++i) acc = add_rn(acc, buf[i]);
  return acc;
}

// Pass 2 for one element (listed row i, column c): its row's segment
// partials [d columns each], added in segment order from 0.
template <typename T>
__device__ __forceinline__ T sum_segments(const T* __restrict__ partial,
                                          const int* __restrict__ row_seg,
                                          int64_t i, int d, int c) {
  T acc = 0;
  for (int64_t k = row_seg[i]; k < row_seg[i + 1]; ++k) {
    acc = add_rn(acc, partial[k * d + c]);
  }
  return acc;
}

inline unsigned warp_grid(int64_t n_items) {
  return (unsigned)((n_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline unsigned thread_grid(int64_t n_items) {
  return (unsigned)((n_items + kThreads - 1) / kThreads);
}

}  // namespace repro_torch
