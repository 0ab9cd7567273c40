// K2: fused residual scatter → reschedule over receiver-sorted CSR rows,
// for sm_90a.
//
//   out[v] = where(consume[v], 0, prio[v]) + Σ_{e: recv(e)=v} w_e · contrib[send(e)]
//
// Replaces the Pallas TPU kernel src/repro/kernels/gas/scatter.py:
// gas_scatter_reschedule_pallas (+ _kernel): the scheduler update
// T ← (T \ executed) ∪ T' of every phase of a fused engine.  The rows are
// cut into segments of at most ROW_SEGMENT edges (row_reduce.cuh):
//   pass 1: one warp per segment; lanes load 32 consecutive edges at once
//           (coalesced senders and weights, gathered contributions) and the
//           ordered warp shuffle adds them in edge order;
//   pass 2: one thread per row writes where(consume, 0, prio), for every
//           row; then one thread per listed row (a row that owns an edge)
//           adds its segment sums, in order, to that.
// w may be null, meaning every real edge weighs 1.
//
// The TPU kernel skips edge blocks whose sources all contribute 0, from a
// bitmap that kernels/gas/ops.py:182-183 builds by reading contrib[senders]
// and the weights.  That bitmap reads the same per-edge data this kernel
// reads, so building it would cost as much as it saves: this kernel drops
// it and reads each edge once.
//
// Bound on the H100: bytes — senders (4 B per edge; weights 4 B more when
// given), the contribution table, prio, consume and the row offsets
// (13 B per row) and the output (4 B per row) at 3.35 TB/s; 1 flop per
// edge (2 with weights).  The contribution table (4 B per vertex) fits in L2 at LiveJournal
// scale, so the random gather mostly hits L2; segments cap the work of one
// warp, so a hub does not serialise the call.
#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

__global__ void __launch_bounds__(kThreads)
segments(const float* __restrict__ contrib, const float* __restrict__ w,
         const int* __restrict__ snd, const int* __restrict__ seg_beg,
         float* __restrict__ partial, int64_t n_seg) {
  const int64_t k = warp_item(n_seg);
  if (k < 0) return;
  const float acc = ordered_range_sum<float>(
      seg_beg[k], seg_beg[k + 1], [&](int64_t e) {
        const float c = __ldg(contrib + __ldg(snd + e));
        return (w == nullptr) ? c : mul_rn(__ldg(w + e), c);
      });
  if ((threadIdx.x & 31) == 0) partial[k] = acc;
}

__global__ void __launch_bounds__(kThreads)
keep(const float* __restrict__ prio, const unsigned char* __restrict__ consume,
     float* __restrict__ out, int64_t n_rows) {
  const int64_t v = thread_item(n_rows);
  if (v >= 0) out[v] = consume[v] ? 0.f : prio[v];
}

__global__ void __launch_bounds__(kThreads)
deposit(const float* __restrict__ partial, const int* __restrict__ row_ids,
        const int* __restrict__ row_seg, float* __restrict__ out, int64_t n_listed) {
  const int64_t i = thread_item(n_listed);
  if (i < 0) return;
  const int64_t v = row_ids[i];
  out[v] = add_rn(out[v], sum_segments(partial, row_seg, i, 1, 0));
}

}  // namespace

// partial: scratch of n_seg floats.  w may be null (all ones).
extern "C" int gas_scatter_reschedule(const void* contrib, const void* prio,
                                      const void* consume, const void* w,
                                      const void* snd, const void* row_ids,
                                      const void* row_seg, const void* seg_beg,
                                      void* partial, void* out, int n_rows,
                                      int n_listed, int n_seg, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (n_seg > 0) {
    segments<<<warp_grid(n_seg), kThreads, 0, s>>>(
        static_cast<const float*>(contrib), static_cast<const float*>(w),
        static_cast<const int*>(snd), static_cast<const int*>(seg_beg), p, n_seg);
  }
  keep<<<thread_grid(n_rows), kThreads, 0, s>>>(
      static_cast<const float*>(prio), static_cast<const unsigned char*>(consume),
      static_cast<float*>(out), n_rows);
  if (n_listed > 0) {
    deposit<<<thread_grid(n_listed), kThreads, 0, s>>>(
        p, static_cast<const int*>(row_ids), static_cast<const int*>(row_seg),
        static_cast<float*>(out), n_listed);
  }
  return static_cast<int>(cudaGetLastError());
}
