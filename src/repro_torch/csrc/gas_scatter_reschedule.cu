// K2: fused residual scatter → reschedule over receiver-sorted CSR rows,
// for sm_90a.
//
//   out[v] = where(consume[v], 0, prio[v]) + Σ_{e: recv(e)=v} w_e · contrib[send(e)]
//
// Replaces the Pallas TPU kernel src/repro/kernels/gas/scatter.py:
// gas_scatter_reschedule_pallas (+ _kernel): the scheduler update
// T ← (T \ executed) ∪ T' of every phase of a fused engine.  w may be null,
// meaning every real edge weighs 1.
//
// The TPU kernel skips edge blocks whose sources all contribute 0, from a
// bitmap that kernels/gas/ops.py builds by reading contrib[senders] and the
// weights each phase; building it reads what it saves.  Here the skip is
// static: the chromatic engine hands each color phase the edges whose
// sender has that color (core/chromatic.py), cut at the full set's segment
// boundaries, and every other sender contributes an exact +0.  Each edge is
// then read once a sweep, not once a color phase.
//
// Bound on the H100: bytes — senders (4 B per edge; weights 4 B more when
// given), the contribution table, prio, consume and the row offsets
// (13 B per row) and the output (4 B per row) at 3.35 TB/s; 1 flop per
// edge (2 with weights).  The contribution table (19 MB at 4.85 M
// vertices) stays in the 50 MB L2, so the random gather costs one 32-byte
// L2 sector an edge, not device memory; the sender stream is read once,
// with evict-first loads, so it does not push the table out.
//
// Design: K1's CSR-stream tiles at D = 1 (gas_gather_combine.cu; the same
// TileTables, RowSegments.tiles):
//   keep:  one thread a row writes where(consume, 0, prio) + 0 for every row
//          (the plain version adds the row's empty sum, +0, to it too, so a
//          prio of -0 comes out +0 in both);
//   tiles: one block a tile streams the tile's senders (and weights)
//          coalesced, gathers their contributions into shared memory, and
//          thread t adds the tile's segment t in edge order from 0.  A row
//          of one segment writes keep + sum in this launch (it overwrites
//          the keep pass's value); a row of two or more leaves partials;
//   combine: one block a row of two or more segments stages its partials
//          and adds them in segment order, then writes keep + sum.
// No shuffle chain: every lane loads on the way in, and an add waits only
// on the add before it.  With a sender-color subset, out equals the full
// set's out to the bit on every row: a full-set segment's left-out terms
// are exact zeros, a segment the subset misses sums to +0, and a row the
// subset misses gets keep + 0 from the keep pass, as the full set gives it.
#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

__device__ __forceinline__ float keep_of(const float* __restrict__ prio,
                                         const unsigned char* __restrict__ consume,
                                         int64_t v) {
  return consume[v] ? 0.f : prio[v];
}

__global__ void __launch_bounds__(kThreads)
keep(const float* __restrict__ prio, const unsigned char* __restrict__ consume,
     float* __restrict__ out, int64_t n_rows) {
  const int64_t v = thread_item(n_rows);
  if (v >= 0) out[v] = add_rn(keep_of(prio, consume, v), 0.f);
}

// Tiles [0, n_partial) leave partial[k]; the others write their rows.
__global__ void __launch_bounds__(kThreads, 8)
tiles_d1(const float* __restrict__ contrib, const float* __restrict__ w,
         const int* __restrict__ snd, const float* __restrict__ prio,
         const unsigned char* __restrict__ consume, const int* __restrict__ seg_beg,
         const int* __restrict__ seg_row, const int* __restrict__ tile_beg,
         const int* __restrict__ tile_end, float* __restrict__ partial,
         float* __restrict__ out, int n_partial) {
  extern __shared__ float term[];
  const int lo = tile_beg[blockIdx.x], hi = tile_end[blockIdx.x];
  const int t = threadIdx.x;
  const int k = lo + t;
  const int base = seg_beg[lo];
  const int n = seg_beg[hi] - base;
  for (int i0 = t; i0 < n; i0 += kThreads * kTileBatch) {
    int s[kTileBatch] = {};
    float wv[kTileBatch] = {}, c[kTileBatch] = {};
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) {  // read once: evict first, keep contrib in L2
        s[j] = __ldcs(snd + base + i);
        if (w != nullptr) wv[j] = __ldcs(w + base + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      if (i0 + j * kThreads < n) c[j] = __ldg(contrib + s[j]);
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) term[i] = (w == nullptr) ? c[j] : mul_rn(wv[j], c[j]);
    }
  }
  __syncthreads();
  if (k < hi) {
    const int e0 = seg_beg[k];
    const float acc = serial_sum(term + (e0 - base), seg_beg[k + 1] - e0, 0.f);
    if ((int)blockIdx.x < n_partial) {
      partial[k] = acc;
    } else {
      const int row = seg_row[k];
      out[row] = add_rn(keep_of(prio, consume, row), acc);
    }
  }
}

// One block a listed row of two or more segments (rows[j]): its partials,
// staged a chunk at a time, added in segment order by one thread.
__global__ void __launch_bounds__(kThreads)
combine_d1(const float* __restrict__ partial, const int* __restrict__ row_ids,
           const int* __restrict__ row_seg, const int* __restrict__ rows,
           const float* __restrict__ prio, const unsigned char* __restrict__ consume,
           float* __restrict__ out) {
  __shared__ float buf[kCombineChunk];
  const int i = rows[blockIdx.x];
  float acc = 0.f;
  for (int c = row_seg[i], end = row_seg[i + 1]; c < end; c += kCombineChunk) {
    const int n = min(kCombineChunk, end - c);
    for (int j = threadIdx.x; j < n; j += kThreads) buf[j] = partial[c + j];
    __syncthreads();
    if (threadIdx.x == 0) acc = serial_sum(buf, n, acc);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int v = row_ids[i];
    out[v] = add_rn(keep_of(prio, consume, v), acc);
  }
}

}  // namespace

// The tile tables (tile_beg, tile_end, multi_rows: kernels/csr.py
// TileTables at D = 1) as K1 takes them; tile_cap is the most edges and
// tile_segs the most segments of any tile (at most kThreads, else
// cudaErrorInvalidValue).  partial: scratch of n_seg floats, read and
// written only when n_partial > 0 (may be null otherwise).  w may be null
// (all ones).
extern "C" int gas_scatter_reschedule(const void* contrib, const void* prio,
                                      const void* consume, const void* w,
                                      const void* snd, const void* row_ids,
                                      const void* row_seg, const void* seg_beg,
                                      const void* seg_row, const void* tile_beg,
                                      const void* tile_end, const void* multi_rows,
                                      void* partial, void* out, int n_rows, int n_tiles,
                                      int n_partial, int n_multi, int tile_cap,
                                      int tile_segs, void* stream) {
  if (n_rows <= 0) return 0;
  if (tile_segs > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(prio);
  const unsigned char* cs = static_cast<const unsigned char*>(consume);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  keep<<<thread_grid(n_rows), kThreads, 0, s>>>(pr, cs, o, n_rows);
  if (n_tiles > 0) {
    tiles_d1<<<n_tiles, kThreads, (size_t)tile_cap * sizeof(float), s>>>(
        static_cast<const float*>(contrib), static_cast<const float*>(w),
        static_cast<const int*>(snd), pr, cs, static_cast<const int*>(seg_beg),
        static_cast<const int*>(seg_row), static_cast<const int*>(tile_beg),
        static_cast<const int*>(tile_end), p, o, n_partial);
  }
  if (n_multi > 0) {
    combine_d1<<<n_multi, kThreads, 0, s>>>(
        p, static_cast<const int*>(row_ids), static_cast<const int*>(row_seg),
        static_cast<const int*>(multi_rows), pr, cs, o);
  }
  return static_cast<int>(cudaGetLastError());
}
