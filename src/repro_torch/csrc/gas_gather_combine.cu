// K1: fused gather⊕combine over receiver-sorted CSR rows, for sm_90a.
//
//   acc[v] = Σ_{e: recv(e)=v} w_e · feat[send(e)]      (feat [N, D] f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/gas/gas.py:
// gas_gather_combine_pallas (+ _kernel).  The TPU design streams a
// sequential grid of (row block × max edge blocks) and combines with a
// one-hot MXU matmul; on a power-law graph most of that grid is empty steps.
// Here the receiver-sorted edges are CSR rows cut into segments of at most
// ROW_SEGMENT edges (row_reduce.cuh, kernels/csr.py), each summed in edge
// order from 0, then a row's segments in segment order, with one rounding a
// product and one an add: the order of the plain version, so the two agree
// bit for bit.
//
// Bound on the H100: bytes.  It must read senders and weights (8 B per
// edge), the feature table (4·D B per vertex), the row offsets (4 B per
// row) and write the output (4·D B per row), at 3.35 TB/s; 2 flops per edge
// and column are far below the compute roofline.  The feature table of a
// whole graph at D = 1 (19 MB at 4.85 M vertices) fits in the 50 MB L2, so
// the random gather costs L2 sectors, not device memory.
//
// D == 1 (PageRank), the CSR-stream design (Greathouse & Daga, SC'14), with
// every sum taken by one thread from shared memory.  The host (TileTables) cuts
// the segments into tiles: runs of consecutive short segments (at most
// SHORT_SEGMENT edges) of one-segment rows share a tile of at most 256 segments
// (TILE_SEGMENTS, tied to kThreads: thread t sums the tile's segment t, so the
// entry refuses a tile of more segments than threads) and
// TILE_WINDOW + SHORT_SEGMENT - 1 edges; every other segment is a tile of
// its own.  One block a tile streams the tile's edge range coalesced, every
// thread staging w[e] · feat[snd[e]] (4 edges a round in flight) into shared
// memory; then thread t adds segment t's products from shared memory in edge
// order.  Every lane loads on the way in, and an add waits only on the add
// before it (no shuffle chain: a warp a segment left ~19 of 32 lanes idle on
// segments of ~13 edges, and a 2048-edge segment of a hub took 2048
// shuffle-and-add steps).  The time of a launch is bounded below by its longest
// chain of adds, so the longest tiles come first in the grid; past that, by the
// chain of dependent loads a tile waits on (its table entries, its rows' active
// bits, its edges, the gathered features), so 8 blocks of 256 threads share an
// SM.  A one-segment row (nearly all rows) writes its output in that launch as
// add_rn(0, acc), what the plain version's zeros().index_add_ gives; a row of
// two or more segments leaves partial sums, and a second launch (combine_d1,
// one block a listed row of that kind) stages them and adds them in segment
// order.  Active blocks: a tile all of whose rows lie in 128-row blocks that
// are off in block_active reads no edge; a tile that mixes active and inactive
// rows stages all its edges (an inactive row's edges may be read), but an
// inactive row is never written and stays an exact zero from the memset.
//
// D >= 2 (no main path yet): one warp per segment, lanes striding over the
// feature columns and looping over the segment's edges in order, into
// `partial`; then one thread per element of every listed row adds its
// row's segment sums.  No D padding and no MAX_FEAT limit.
#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

__device__ __forceinline__ bool row_active(const int* block_active, int64_t v,
                                           int row_block) {
  return block_active == nullptr || block_active[v / row_block] != 0;
}

// Tiles [0, n_partial) leave partial[k]; the others write their rows.
// At most 32 registers, so that 8 blocks fit an SM.
__global__ void __launch_bounds__(kThreads, 8)
segments_d1(const float* __restrict__ feat, const float* __restrict__ w,
            const int* __restrict__ snd, const int* __restrict__ seg_beg,
            const int* __restrict__ seg_row, const int* __restrict__ tile_beg,
            const int* __restrict__ tile_end, const int* __restrict__ block_active,
            float* __restrict__ partial, float* __restrict__ out, int n_partial,
            int row_block) {
  extern __shared__ float prod[];
  const int lo = tile_beg[blockIdx.x], hi = tile_end[blockIdx.x];
  const int t = threadIdx.x;
  const int k = lo + t;
  const int base = seg_beg[lo];
  const int n = seg_beg[hi] - base;
  int row = 0, e0 = 0, e1 = 0;
  bool act = false;
  if (k < hi) {
    row = seg_row[k];
    e0 = seg_beg[k];
    e1 = seg_beg[k + 1];
    act = row_active(block_active, row, row_block);
  }
  if (!__syncthreads_or(act)) return;
  for (int i0 = t; i0 < n; i0 += kThreads * kTileBatch) {
    int s[kTileBatch] = {};
    float wv[kTileBatch] = {}, f[kTileBatch] = {};
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) {  // read once: evict first, keep the feature table in L2
        s[j] = __ldcs(snd + base + i);
        wv[j] = __ldcs(w + base + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      if (i0 + j * kThreads < n) f[j] = __ldg(feat + s[j]);
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) prod[i] = mul_rn(wv[j], f[j]);
    }
  }
  __syncthreads();
  if (act) {
    const float acc = serial_sum(prod + (e0 - base), e1 - e0, 0.f);
    if ((int)blockIdx.x < n_partial) {
      partial[k] = acc;
    } else {
      out[row] = add_rn(0.f, acc);
    }
  }
}

// One block a listed row of two or more segments (rows[j]): its partials,
// staged a chunk at a time, added in segment order by one thread.
__global__ void __launch_bounds__(kThreads)
combine_d1(const float* __restrict__ partial, const int* __restrict__ row_ids,
           const int* __restrict__ row_seg, const int* __restrict__ rows,
           const int* __restrict__ block_active, float* __restrict__ out, int row_block) {
  __shared__ float buf[kCombineChunk];
  const int i = rows[blockIdx.x];
  const int v = row_ids[i];
  if (!row_active(block_active, v, row_block)) return;
  float acc = 0.f;
  for (int c = row_seg[i], end = row_seg[i + 1]; c < end; c += kCombineChunk) {
    const int n = min(kCombineChunk, end - c);
    for (int j = threadIdx.x; j < n; j += kThreads) buf[j] = partial[c + j];
    __syncthreads();
    if (threadIdx.x == 0) acc = serial_sum(buf, n, acc);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[v] = acc;
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

// One thread per element of a listed row.
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

// partial: scratch of n_seg * d floats (d == 1: written and read only
// when n_partial > 0; may be null otherwise).  block_active may be null
// (all on).  The tile tables (tile_beg, tile_end, multi_rows:
// kernels/csr.py TileTables) are read when d == 1 and may be null
// otherwise; tile_cap is the most edges and tile_segs the most segments of any
// tile (at most kThreads, else cudaErrorInvalidValue).
extern "C" int gas_gather_combine(const void* feat, const void* w, const void* snd,
                                  const void* row_ids, const void* row_seg,
                                  const void* seg_beg, const void* seg_row,
                                  const void* block_active, const void* tile_beg,
                                  const void* tile_end, const void* multi_rows,
                                  void* partial, void* out, int n_rows, int n_listed,
                                  int n_seg, int d, int row_block, int n_tiles,
                                  int n_partial, int n_multi, int tile_cap, int tile_segs,
                                  void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  if (d == 1 && tile_segs > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(float), s);
  const float* f = static_cast<const float*>(feat);
  const float* wt = static_cast<const float*>(w);
  const int* sn = static_cast<const int*>(snd);
  const int* sb = static_cast<const int*>(seg_beg);
  const int* sr = static_cast<const int*>(seg_row);
  const int* ba = static_cast<const int*>(block_active);
  const int* ri = static_cast<const int*>(row_ids);
  const int* rs = static_cast<const int*>(row_seg);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (d == 1) {
    if (n_tiles > 0) {
      segments_d1<<<n_tiles, kThreads, (size_t)tile_cap * sizeof(float), s>>>(
          f, wt, sn, sb, sr, static_cast<const int*>(tile_beg),
          static_cast<const int*>(tile_end), ba, p, o, n_partial, row_block);
    }
    if (n_multi > 0) {
      combine_d1<<<n_multi, kThreads, 0, s>>>(p, ri, rs, static_cast<const int*>(multi_rows),
                                              ba, o, row_block);
    }
  } else {
    if (n_seg > 0) {
      segments_cols<<<warp_grid(n_seg), kThreads, 0, s>>>(f, wt, sn, sb, sr, ba, p,
                                                          n_seg, d, row_block);
    }
    if (n_listed > 0) {
      combine<<<thread_grid((int64_t)n_listed * d), kThreads, 0, s>>>(p, ri, rs, ba, o,
                                                                      n_listed, d, row_block);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
