// K3: sorted segment sum [E, D] → [N, D] over receiver-sorted CSR rows,
// for sm_90a, in f32 or f64.
//
//   out[v, :] = Σ_{e: recv(e)=v} msgs[e, :]
//
// Replaces the Pallas TPU kernel src/repro/kernels/segsum/segsum.py:
// segment_sum_sorted_pallas (+ _kernel): the dense segment_combine sum of
// the apply phase (LBP's message sum; PageRank's with use_fused=False).
// The TPU grid walks (row block, feature block, edge block) in order and
// scatters with a one-hot MXU matmul.  f64 serves programs whose data is
// f64 (LBP below the f32 residual floor).
//
// Bound on the H100: bytes — the messages (sizeof(T)·D B per edge), the
// row offsets (4 B per row) and the output (sizeof(T)·D B per row) at
// 3.35 TB/s; one add per element.
//
// D <= kThreads (every path of the port; LBP's D = 5): CSR-stream tiles
// (kernels/segsum/segsum.py tile_shape, csr.py TileTables).  A tile is a
// run of segments whose messages are one contiguous [edges × D] span; the
// host packs at most kThreads / D segments a tile, so that thread t owns
// the pair (segment t / D, column t % D).  The block stages the span into
// shared memory with coalesced 16-byte evict-first loads (an unaligned head
// and tail element by element), a chunk of at most `chunk` edges at a time,
// and each thread adds its column of its segment's edges in that chunk,
// in edge order, to its running sum; chunks go in edge order, so the sum is
// the plain version's.  A row of one segment writes 0 + sum directly; a row
// of two or more leaves partials that a second launch (one thread a column
// of such a row) adds in segment order.  This replaces one warp a segment
// with lanes over the columns: at D = 5 it kept 5 of 32 lanes busy, each
// with a chain of dependent 4-byte loads.
//
// D > kThreads (no path of the port yet): a segment's columns outnumber a
// block's threads, so one warp a segment keeps the old design — lanes over
// the columns, each summing its column in edge order into `partial` — and
// a warp's loads are coalesced at that width; then one thread per element
// of every listed row adds its row's partials.
#include <type_traits>

#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

// buf[0] + ... in steps of `stride`, n terms, added in order to acc.
template <typename T>
__device__ __forceinline__ T strided_sum(const T* buf, int n, int stride, T acc) {
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    T v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = buf[(i + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = add_rn(acc, v[j]);
  }
  for (; i < n; ++i) acc = add_rn(acc, buf[i * stride]);
  return acc;
}

// Copies src[lo, hi) to buf[lo - a0, hi - a0), a0 = lo rounded down to 16
// bytes (so buf holds hi - lo + 16 / sizeof(T) - 1 elements); returns a0.
// With vec_ok (src 16-byte aligned) the aligned middle moves as 16-byte
// vectors, kTileBatch a thread in flight.
template <typename T>
__device__ __forceinline__ int64_t stage(const T* __restrict__ src, int64_t lo, int64_t hi,
                                         T* __restrict__ buf, bool vec_ok) {
  using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  constexpr int V = 16 / sizeof(T);
  const int64_t a0 = lo & ~(int64_t)(V - 1);
  const int t = threadIdx.x;
  if (!vec_ok) {
    for (int64_t i = lo + t; i < hi; i += kThreads) buf[i - a0] = __ldcs(src + i);
    return a0;
  }
  const int64_t vlo = min((lo + V - 1) & ~(int64_t)(V - 1), hi);
  const int64_t vhi = max(hi & ~(int64_t)(V - 1), vlo);
  if (lo + t < vlo) buf[lo + t - a0] = __ldcs(src + lo + t);  // head
  if (vhi + t < hi) buf[vhi + t - a0] = __ldcs(src + vhi + t);  // tail
  const Vec* vs = reinterpret_cast<const Vec*>(src + vlo);
  Vec* vb = reinterpret_cast<Vec*>(buf + (vlo - a0));
  const int nv = (int)((vhi - vlo) / V);
  for (int i0 = t; i0 < nv; i0 += kThreads * kTileBatch) {
    Vec x[kTileBatch];
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      if (i0 + j * kThreads < nv) x[j] = __ldcs(vs + i0 + j * kThreads);
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      if (i0 + j * kThreads < nv) vb[i0 + j * kThreads] = x[j];
    }
  }
  return a0;
}

// Tiles [0, n_partial) leave partial[k, :]; the others write their rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiles(const T* __restrict__ msgs, const int* __restrict__ seg_beg,
      const int* __restrict__ seg_row, const int* __restrict__ tile_beg,
      const int* __restrict__ tile_end, T* __restrict__ partial, T* __restrict__ out,
      int d, int chunk, int n_partial, bool vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int lo = tile_beg[blockIdx.x], hi = tile_end[blockIdx.x];
  const int k = lo + (int)threadIdx.x / d;
  const int c = (int)threadIdx.x % d;
  const bool mine = k < hi;
  int64_t e0 = 0, e1 = 0;
  if (mine) {
    e0 = seg_beg[k];
    e1 = seg_beg[k + 1];
  }
  const int64_t tb = seg_beg[lo], te = seg_beg[hi];
  T acc = 0;
  for (int64_t ea = tb; ea < te; ea += chunk) {
    const int64_t eb = min(ea + chunk, te);
    const int64_t a0 = stage(msgs, ea * d, eb * d, buf, vec_ok);
    __syncthreads();
    const int64_t x0 = max(e0, ea), x1 = min(e1, eb);
    if (mine && x0 < x1) {
      acc = strided_sum(buf + (x0 * d + c - a0), (int)(x1 - x0), d, acc);
    }
    __syncthreads();
  }
  if (mine) {
    if ((int)blockIdx.x < n_partial) {
      partial[(int64_t)k * d + c] = acc;
    } else {
      out[(int64_t)seg_row[k] * d + c] = add_rn(T(0), acc);
    }
  }
}

// One thread a column of a listed row of two or more segments (rows[j]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_multi(const T* __restrict__ partial, const int* __restrict__ row_ids,
              const int* __restrict__ row_seg, const int* __restrict__ rows,
              T* __restrict__ out, int64_t n_multi, int d) {
  const int64_t j = thread_item(n_multi * d);
  if (j < 0) return;
  const int64_t i = rows[j / d];
  const int c = (int)(j % d);
  out[(int64_t)row_ids[i] * d + c] = sum_segments(partial, row_seg, i, d, c);
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
            const void* seg_beg, const void* seg_row, const void* tile_beg,
            const void* tile_end, const void* multi_rows, void* partial, void* out,
            int n_rows, int n_listed, int n_seg, int d, int n_tiles, int n_partial,
            int n_multi, int chunk, cudaStream_t s) {
  // rows that own no edge are zeros; every listed row is written below
  if (n_listed < n_rows) cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(T), s);
  const T* m = static_cast<const T*>(msgs);
  const int* ri = static_cast<const int*>(row_ids);
  const int* rs = static_cast<const int*>(row_seg);
  const int* sb = static_cast<const int*>(seg_beg);
  T* p = static_cast<T*>(partial);
  T* o = static_cast<T*>(out);
  if (d <= kThreads) {
    if (n_tiles > 0) {
      const bool vec_ok = (reinterpret_cast<uintptr_t>(msgs) & 15) == 0;
      const size_t smem = ((size_t)chunk * d + 16 / sizeof(T)) * sizeof(T);
      tiles<T><<<n_tiles, kThreads, smem, s>>>(
          m, sb, static_cast<const int*>(seg_row), static_cast<const int*>(tile_beg),
          static_cast<const int*>(tile_end), p, o, d, chunk, n_partial, vec_ok);
    }
    if (n_multi > 0) {
      combine_multi<T><<<thread_grid((int64_t)n_multi * d), kThreads, 0, s>>>(
          p, ri, rs, static_cast<const int*>(multi_rows), o, n_multi, d);
    }
    return;
  }
  if (n_seg > 0) {
    segments_cols<T><<<warp_grid(n_seg), kThreads, 0, s>>>(m, sb, p, n_seg, d);
  }
  if (n_listed > 0) {
    combine<T><<<thread_grid((int64_t)n_listed * d), kThreads, 0, s>>>(p, ri, rs, o,
                                                                       n_listed, d);
  }
}

}  // namespace

// f64 != 0 selects double messages, scratch and output, else float.
// d <= kThreads: the tile tables (tile_beg, tile_end, multi_rows: csr.py
// TileTables at segsum.py's tile_shape(d, element size)); tile_segs · d must
// not exceed kThreads (else cudaErrorInvalidValue), and the block stages
// `chunk` edges at a time (chunk · d + 16 B of shared memory, at most 48 KB).
// partial: scratch of n_seg · d elements, written only by the first
// n_partial tiles (may be null when n_partial == 0).  d > kThreads: the
// tables are not read and partial is always written.
extern "C" int segment_sum_sorted(const void* msgs, const void* row_ids,
                                  const void* row_seg, const void* seg_beg,
                                  const void* seg_row, const void* tile_beg,
                                  const void* tile_end, const void* multi_rows,
                                  void* partial, void* out, int n_rows, int n_listed,
                                  int n_seg, int d, int f64, int n_tiles, int n_partial,
                                  int n_multi, int chunk, int tile_segs, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const size_t size = f64 ? sizeof(double) : sizeof(float);
  if (d <= kThreads && (tile_segs * d > kThreads || (n_tiles > 0 && chunk <= 0) ||
                        ((size_t)chunk * d + 16 / size) * size > 48 * 1024)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(msgs, row_ids, row_seg, seg_beg, seg_row, tile_beg, tile_end,
                   multi_rows, partial, out, n_rows, n_listed, n_seg, d, n_tiles,
                   n_partial, n_multi, chunk, s);
  } else {
    launch<float>(msgs, row_ids, row_seg, seg_beg, seg_row, tile_beg, tile_end,
                  multi_rows, partial, out, n_rows, n_listed, n_seg, d, n_tiles,
                  n_partial, n_multi, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
