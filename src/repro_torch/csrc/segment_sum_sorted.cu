// K3: sorted segment sum [E, D] → [N, D] over receiver-sorted CSR rows,
// for sm_90a, in f32 or f64.
//
//   out[v, :] = Σ_{e: recv(e)=v} msgs[e, :]
//
// Replaces the Pallas TPU kernel src/repro/kernels/segsum/segsum.py:
// segment_sum_sorted_pallas (+ _kernel): the dense segment_combine sum of
// the apply phase (LBP's message sum; PageRank's with use_fused=False).
// The TPU grid walks (row block, feature block, edge block) in order and
// scatters with a one-hot MXU matmul.  Here the rows are cut into segments
// of at most ROW_SEGMENT edges (row_reduce.cuh):
//   pass 1: one warp per segment reads msgs[seg_beg[k]:seg_beg[k+1], :]
//           directly.  D >= 2: lanes stride over the columns, each summing
//           its column in edge order; D == 1: lanes load 32 consecutive
//           messages at once and the ordered warp shuffle adds them;
//   pass 2: the output is zeroed, then one thread per element of a listed
//           row (a row that owns an edge) adds its row's segment sums.
// Pad receivers (>= n) lie past the last segment and are never read.  f64
// serves programs whose data is f64 (LBP below the f32 residual floor).
//
// Bound on the H100: bytes — the messages (sizeof(T)·D B per edge), the
// row offsets (4 B per row) and the output (sizeof(T)·D B per row) at
// 3.35 TB/s; one add per element.  A warp reads consecutive memory, so the
// message stream is coalesced for D >= 32 and within a segment's span below
// that (LBP's D = 5 uses 5 of 32 lanes per load).
#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segments_d1(const T* __restrict__ msgs, const int* __restrict__ seg_beg,
            T* __restrict__ partial, int64_t n_seg) {
  const int64_t k = warp_item(n_seg);
  if (k < 0) return;
  const T acc = ordered_range_sum<T>(seg_beg[k], seg_beg[k + 1],
                                     [&](int64_t e) { return __ldg(msgs + e); });
  if ((threadIdx.x & 31) == 0) partial[k] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segments_cols(const T* __restrict__ msgs, const int* __restrict__ seg_beg,
              T* __restrict__ partial, int64_t n_seg, int d) {
  const int64_t k = warp_item(n_seg);
  if (k < 0) return;
  const int64_t beg = seg_beg[k], end = seg_beg[k + 1];
  for (int c = threadIdx.x & 31; c < d; c += 32) {
    T acc = 0;
    for (int64_t e = beg; e < end; ++e) acc = add_rn(acc, __ldg(msgs + e * d + c));
    partial[k * d + c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine(const T* __restrict__ partial, const int* __restrict__ row_ids,
        const int* __restrict__ row_seg, T* __restrict__ out, int64_t n_listed,
        int d) {
  const int64_t j = thread_item(n_listed * d);
  if (j < 0) return;
  const int64_t i = j / d;
  const int c = (int)(j % d);
  out[(int64_t)row_ids[i] * d + c] = sum_segments(partial, row_seg, i, d, c);
}

template <typename T>
void launch(const void* msgs, const void* row_ids, const void* row_seg,
            const void* seg_beg, void* partial, void* out, int n_rows, int n_listed,
            int n_seg, int d, cudaStream_t s) {
  cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(T), s);
  const T* m = static_cast<const T*>(msgs);
  const int* sb = static_cast<const int*>(seg_beg);
  T* p = static_cast<T*>(partial);
  if (n_seg > 0) {
    if (d == 1) {
      segments_d1<T><<<warp_grid(n_seg), kThreads, 0, s>>>(m, sb, p, n_seg);
    } else {
      segments_cols<T><<<warp_grid(n_seg), kThreads, 0, s>>>(m, sb, p, n_seg, d);
    }
  }
  if (n_listed > 0) {
    combine<T><<<thread_grid((int64_t)n_listed * d), kThreads, 0, s>>>(
        p, static_cast<const int*>(row_ids), static_cast<const int*>(row_seg),
        static_cast<T*>(out), n_listed, d);
  }
}

}  // namespace

// partial: scratch of n_seg * d elements.  f64 != 0 selects double
// messages, scratch and output, else float.
extern "C" int segment_sum_sorted(const void* msgs, const void* row_ids,
                                  const void* row_seg, const void* seg_beg,
                                  void* partial, void* out, int n_rows, int n_listed,
                                  int n_seg, int d, int f64, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(msgs, row_ids, row_seg, seg_beg, partial, out, n_rows, n_listed,
                   n_seg, d, s);
  } else {
    launch<float>(msgs, row_ids, row_seg, seg_beg, partial, out, n_rows, n_listed,
                  n_seg, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
