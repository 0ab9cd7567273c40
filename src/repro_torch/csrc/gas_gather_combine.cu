// K1: fused gather⊕combine over receiver-sorted CSR rows, for sm_90a.
//
//   acc[v] = Σ_{e: recv(e)=v} w_e · feat[send(e)]      (feat [N, D] f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/gas/gas.py:
// gas_gather_combine_pallas (+ _kernel).  The TPU design streams a
// sequential grid of (row block × max edge blocks) and combines with a
// one-hot MXU matmul; on a power-law graph most of that grid is empty steps.
// Here the receiver-sorted edges are CSR rows cut into segments of at most
// ROW_SEGMENT edges (row_reduce.cuh), and
//   pass 1: one warp per segment.  D == 1 (PageRank): lanes load 32
//           consecutive edges at once (coalesced w and senders, gathered
//           feat) and the ordered warp shuffle adds them in edge order.
//           D >= 2: lanes stride over the feature columns, looping over the
//           segment's edges in order;
//   pass 2: the output is zeroed, then one thread per element of a listed
//           row (a row that owns an edge of this subset) adds its row's
//           segment sums.
// A segment whose row lies in a 128-row block that is off in block_active
// reads no edge, and its row stays zero — the TPU kernel's active-block
// skipping.  The chromatic engine's per-color subsets list only that
// color's rows, so pass 2 touches no other row.  No D padding and no
// MAX_FEAT limit.
//
// Bound on the H100: bytes.  It must read senders and weights (8 B per
// edge), the feature table (4·D B per vertex), the row offsets (4 B per
// row) and write the output (4·D B per row), at 3.35 TB/s; 2 flops per edge
// and column are far below the compute roofline.  Design against it:
// senders and weights stream coalesced, once; the feature table of a whole
// graph at D = 1 (19 MB at 4.85 M vertices) fits in the 50 MB L2, so the
// random gather mostly hits L2; segments cap the work of one warp, so a hub
// no longer serialises the call.  The serial, ordered adds cost latency
// that a tree reduction would not; they buy bit-equality with the CPU.
#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

__device__ __forceinline__ bool row_active(const int* block_active, int64_t v,
                                           int row_block) {
  return block_active == nullptr || block_active[v / row_block] != 0;
}

__global__ void __launch_bounds__(kThreads)
segments_d1(const float* __restrict__ feat, const float* __restrict__ w,
            const int* __restrict__ snd, const int* __restrict__ seg_beg,
            const int* __restrict__ seg_row, const int* __restrict__ block_active,
            float* __restrict__ partial, int64_t n_seg, int row_block) {
  const int64_t k = warp_item(n_seg);
  if (k < 0 || !row_active(block_active, seg_row[k], row_block)) return;
  const float acc = ordered_range_sum<float>(
      seg_beg[k], seg_beg[k + 1], [&](int64_t e) {
        return mul_rn(__ldg(w + e), __ldg(feat + __ldg(snd + e)));
      });
  if ((threadIdx.x & 31) == 0) partial[k] = acc;
}

__global__ void __launch_bounds__(kThreads)
segments_cols(const float* __restrict__ feat, const float* __restrict__ w,
              const int* __restrict__ snd, const int* __restrict__ seg_beg,
              const int* __restrict__ seg_row, const int* __restrict__ block_active,
              float* __restrict__ partial, int64_t n_seg, int d, int row_block) {
  const int64_t k = warp_item(n_seg);
  if (k < 0 || !row_active(block_active, seg_row[k], row_block)) return;
  const int64_t beg = seg_beg[k], end = seg_beg[k + 1];
  for (int c = threadIdx.x & 31; c < d; c += 32) {
    float acc = 0.f;
    for (int64_t e = beg; e < end; ++e) {
      const float x = __ldg(feat + (int64_t)__ldg(snd + e) * d + c);
      acc = add_rn(acc, mul_rn(__ldg(w + e), x));
    }
    partial[k * d + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
combine(const float* __restrict__ partial, const int* __restrict__ row_ids,
        const int* __restrict__ row_seg, const int* __restrict__ block_active,
        float* __restrict__ out, int64_t n_listed, int d, int row_block) {
  const int64_t j = thread_item(n_listed * d);
  if (j < 0) return;
  const int64_t i = j / d, v = row_ids[i];
  const int c = (int)(j % d);
  if (row_active(block_active, v, row_block)) {
    out[v * d + c] = sum_segments(partial, row_seg, i, d, c);
  }
}

}  // namespace

// partial: scratch of n_seg * d floats.  block_active may be null (all on).
extern "C" int gas_gather_combine(const void* feat, const void* w, const void* snd,
                                  const void* row_ids, const void* row_seg,
                                  const void* seg_beg, const void* seg_row,
                                  const void* block_active, void* partial, void* out,
                                  int n_rows, int n_listed, int n_seg, int d,
                                  int row_block, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(float), s);
  const float* f = static_cast<const float*>(feat);
  const float* wt = static_cast<const float*>(w);
  const int* sn = static_cast<const int*>(snd);
  const int* sb = static_cast<const int*>(seg_beg);
  const int* sr = static_cast<const int*>(seg_row);
  const int* ba = static_cast<const int*>(block_active);
  float* p = static_cast<float*>(partial);
  if (n_seg > 0) {
    if (d == 1) {
      segments_d1<<<warp_grid(n_seg), kThreads, 0, s>>>(f, wt, sn, sb, sr, ba, p,
                                                        n_seg, row_block);
    } else {
      segments_cols<<<warp_grid(n_seg), kThreads, 0, s>>>(f, wt, sn, sb, sr, ba, p,
                                                          n_seg, d, row_block);
    }
  }
  if (n_listed > 0) {
    combine<<<thread_grid((int64_t)n_listed * d), kThreads, 0, s>>>(
        p, static_cast<const int*>(row_ids), static_cast<const int*>(row_seg), ba,
        static_cast<float*>(out), n_listed, d, row_block);
  }
  return static_cast<int>(cudaGetLastError());
}
