// Shared pieces of the port's CSR row reductions (K1, K2, K3).
//
// The receiver-sorted edges of a row are cut into consecutive segments of
// at most ROW_SEGMENT edges (src/repro_torch/kernels/csr.py builds the
// tables).  The tables list only the rows that own an edge (row_ids), so a
// color's edge subset costs tables of its own size.  K2, K3 and K1 at
// D >= 2 run in two passes:
//   pass 1: one warp per segment k sums its edges in edge order into
//           partial[k] (a power-law hub spreads over many warps);
//   pass 2: one thread per element of a listed row adds the row's segment
//           partials in segment order; rows that own no edge are filled
//           before (zeros, or K2's kept priority).
// K1 at D == 1 stages each segment's terms in shared memory, where one
// thread adds them, and writes one-segment rows in pass 1
// (gas_gather_combine.cu); the order is the same.
// Each add is one correctly rounded add and each product one correctly
// rounded multiply (__fadd_rn / __fmul_rn keep nvcc from contracting them
// into an FMA).  That is the order and rounding of the plain PyTorch
// versions (sequential index_add_ over segments, then over rows), so each
// kernel's output equals its plain version bit for bit, and an engine on
// the card takes the same schedule as on the CPU.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

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

// Σ term(e) for e in [beg, end), added in edge order.  Lanes load 32
// consecutive edges at once (coalesced), one chunk ahead of the adds; the
// shuffle then feeds the chunk to the running sum in lane order.  Every
// lane returns the same sum.
template <typename T, typename Term>
__device__ __forceinline__ T ordered_range_sum(int64_t beg, int64_t end, Term term) {
  const int lane = threadIdx.x & 31;
  T acc = 0;
  T m = (beg + lane < end) ? term(beg + lane) : T(0);
  for (int64_t base = beg; base < end; base += 32) {
    const int64_t next = base + 32 + lane;
    const T m_next = (next < end) ? term(next) : T(0);
    if (end - base >= 32) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc = add_rn(acc, __shfl_sync(kFullMask, m, k));
    } else {
      const int cnt = (int)(end - base);
      for (int k = 0; k < cnt; ++k) acc = add_rn(acc, __shfl_sync(kFullMask, m, k));
    }
    m = m_next;
  }
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
