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
// D >= 2 (ALS's 400 and 20 columns, CoEM's 204: the distributed engine's
// stacked launch a leaf a phase, dist/engine.py _fused_acc, and
// ChromaticEngine's gather).  Bound: the same bytes, but a kernel that
// gathers one row an edge moves 4·D B an edge (166.6 GB at D 400 on the
// Netflix ALS set) against a few GB of distinct rows, so what it can reach
// is the per-edge gather over what L2 and HBM deliver together, and below
// that it is held back by the loads in flight and the work around each
// edge.  The host (ColumnItems) cuts the segments into items, runs of
// whole segments that start in one aligned span of 1024 edges, over all D
// columns (slices of at most 512 where D is wider), in row order.  Warps
// are persistent and claim items one at a time from a counter they share,
// so the warps in flight work on neighbouring rows (the machines of a
// stacked set one after another) and share the sender rows that L2 holds,
// and a warp whose items are short or inactive (no active row block, seen
// when it takes one) claims more.  The warp streams its items' edges
// through its own 3-stage ring in shared memory (~8 KB a stage, 32 edges
// at most), two chunks of gathers ahead of the adds, across item
// boundaries: each lane issues one edge of a chunk, whose sender and
// weight it loaded (evict-first) two steps earlier, staging the weight and
// gathering the edge's row slice with one cp.async.bulk on the stage's
// mbarrier (rows of at most 128 bytes: the lanes copy the chunk's rows in
// 16-byte cp.async pieces, which measured faster there; 4-byte cp.async
// where D is not a multiple of 4 or the table is not 16-byte aligned, e.g.
// a view at a row offset).  So senders and weights are read once, not once
// every 32 columns.  Lane l adds columns l, l + 32, ... of the current
// segment in edge order from 0 (up to 16 independent chains), in runs that
// end at the segment's end, and writes them there: 0 + sum for a row of
// one segment, else a partial that combine_cols adds in segment order.
// Rows of at most 32 columns leave most lanes idle in the adds, so there
// every lane first multiplies the stage by the weights in place, and the
// adds take one load an edge.
// Narrower column slices as the outer order (so that one slice of the
// table stays in L2) were measured and lose at every width: each slice
// pays the whole per-edge work again (PERF.md, section 6).
#include <algorithm>

#include "row_reduce.cuh"

namespace {

using namespace repro_torch;

// (a 32-bit row: a 64-bit divide is a called subroutine, and its call
// made the one-column-a-lane D >= 2 kernels spill)
__device__ __forceinline__ bool row_active(const int* block_active, int v, int row_block) {
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

// ---- D >= 2 -------------------------------------------------------------
// kStageBytes and kMaxPerLane (a slice of at most 32 * kMaxPerLane
// columns) are mirrored in kernels/csr.py (COL_STAGE_BYTES,
// COL_MAX_WIDTH), which cuts the items to fit them.
constexpr int kColWarps = 4;  // warps a block, each on its own items
constexpr int kStages = 3;
constexpr int kStageBytes = 8 * 1024;
constexpr int kMaxPerLane = 16;
constexpr int kChunkEdges = 32;  // the most edges a chunk: one a lane
constexpr int kDescs = 8;  // chunk descriptors a warp, a ring
enum CopyMode { kCopyBulk = 0, kCopy16 = 1, kCopy4 = 2 };
// Rows of at most this many bytes go by 16-byte cp.async pieces, wider ones
// by cp.async.bulk (H100 80GB HBM3 at 700 W, chip_smoke.py phase 6: pieces
// 3.30 ms against bulk 3.98 at 80-byte rows, bulk 7.44 against 8.22 at
// 816 bytes; PERF.md, section 6).
constexpr int kPieceRowBytes = 128;

// Edges a ring stage holds at a slice of `width` columns (one a lane).
__device__ __forceinline__ int col_chunk(int width) {
  return min(kChunkEdges, max(1, kStageBytes / (4 * width)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One chunk of a warp's stream: edges [ea, ea + n) of the item of segments
// [lo, hi) over the columns [c0, c0 + width).  flags: kValid, kFirst /
// kLast chunk of its item.  inv (rows of at most 32 columns):
// 2^16 / (width / 4) where width % 4 == 0, else 2^16 / width, rounded up;
// (i * inv) >> 16 is then i / (width / 4) (or i / width) for every index
// i of a chunk's 4-float pieces (floats).
struct Chunk {
  int lo, hi, c0, width, ea, n, flags, inv;
};
constexpr int kValid = 1, kFirst = 2, kLast = 4;

// A warp's part of the block's shared memory; its ring of gathered rows
// [kStages][stage_floats] follows it.
struct alignas(16) WarpRing {
  uint64_t bar[kStages];
  Chunk desc[kDescs];
  float w[kStages][kChunkEdges];
};

__device__ __forceinline__ int shfl(int v, int lane) {
  return __shfl_sync(0xFFFFFFFFu, v, lane);
}

// Thirty-two segments' ends and rows, lane j holding segment k0 + j, and
// their flags (bit 0: the row has two or more segments; bit 1: the row is
// active).  load() only issues the loads; finish() waits for them.
struct SegBatch {
  int end, row, prev, next, flags;
  __device__ void load(const int* seg_beg, const int* seg_row, int k0, int hi, int n_seg) {
    const int k = k0 + (threadIdx.x & 31);
    end = row = 0;
    prev = next = -1;
    if (k < hi) {
      end = seg_beg[k + 1];
      row = seg_row[k];
      if (k > 0) prev = seg_row[k - 1];
      if (k + 1 < n_seg) next = seg_row[k + 1];
    }
  }
  __device__ void finish(const int* block_active, int row_block) {
    flags = (prev == row || next == row ? 1 : 0) |
            (row_active(block_active, row, row_block) ? 2 : 0);
  }
};

// Persistent, one warp an item at a time, claimed in turn.  A warp's items
// form one stream of chunks, kStages - 1 chunks of gathers ahead of the
// adds, across item boundaries: at step g it issues chunk g + kStages - 1
// (weights, row gathers) from registers loaded at step g - 2, loads chunk
// g + kStages + 1's senders and weights, plans chunk g + kStages + 2 (and
// claims the next item when it takes one), and adds chunk g.  Lane l owns
// the slice's columns l, l + 32, ... (up to kPerLane of them) and adds
// each segment's edges in edge order from 0, writing at the segment's end.
// kCopyBulk: one cp.async.bulk an edge, on the stage's mbarrier (lane 0
// posts the bytes before the copies are issued); kCopy16: the lanes copy
// consecutive 16-byte pieces of the chunk's rows with cp.async, 32 / q
// whole rows of q pieces a round; kCopy4: each lane copies its edge's row
// slice 4 bytes at a time.
template <int kMode, int kPerLane>
__global__ void __launch_bounds__(32 * kColWarps)
items_cols(const float* __restrict__ feat, const float* __restrict__ w,
           const int* __restrict__ snd, const int* __restrict__ seg_beg,
           const int* __restrict__ seg_row, const int4* __restrict__ items,
           const int* __restrict__ block_active, float* __restrict__ partial,
           float* __restrict__ out, int* __restrict__ counter, int n_items, int n_seg, int d,
           int stage_floats, int row_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* base =
      smem + (size_t)warp * (sizeof(WarpRing) + (size_t)kStages * stage_floats * 4);
  WarpRing& ring = *reinterpret_cast<WarpRing*>(base);
  float* rows = reinterpret_cast<float*>(base + sizeof(WarpRing));
  // the planner.  Each warp claims its next item from a counter that every
  // warp shares (so the warps in flight work on neighbouring items in row
  // order, and a warp whose items are short or inactive claims more): lane
  // 0 claims the item after the current one when it takes the current one,
  // the record is loaded two steps later, and the item is checked against
  // the active row blocks when it is taken.
  int claim = 0, claimed_at = 0, nj = 0, planned = 0;
  int4 na = {}, nb = {};
  bool staged = false, done = false, have = false;
  int it_lo = 0, it_hi = 0, it_c0 = 0, it_width = 0, it_inv = 0, it_lo_e = 0, it_hi_e = 0;
  int next_e = 0, chunk = 1;
  auto claim_next = [&]() {
    if (lane == 0) claim = atomicAdd(counter, 1);
    claimed_at = planned;
    staged = false;
  };
  auto stage = [&]() {  // the claimed item's record
    nj = shfl(claim, 0);
    if (nj < n_items) {
      na = items[2 * nj];
      nb = items[2 * nj + 1];
    }
    staged = true;
  };
  claim_next();
  auto plan = [&]() {
    Chunk c = {};
    while (!have && !done) {
      if (!staged) stage();
      if (nj >= n_items) {
        done = true;
        break;
      }
      const int4 a = na, b = nb;
      claim_next();
      bool ok = true;
      if (block_active != nullptr) {  // any of the item's row blocks on
        ok = false;
        for (int r = b.y / row_block + lane; r <= b.z / row_block && !ok; r += 32) {
          ok = block_active[r] != 0;
        }
        ok = __any_sync(0xFFFFFFFFu, ok);
      }
      if (ok) {
        it_lo = a.x;
        it_hi = a.y;
        it_c0 = a.z;
        it_lo_e = a.w;
        it_hi_e = b.x;
        it_width = b.w;
        next_e = it_lo_e;
        chunk = col_chunk(it_width);
        if (kPerLane == 1) {
          const int div = it_width % 4 == 0 ? it_width / 4 : it_width;
          it_inv = ((1 << 16) + div - 1) / div;
        }
        have = true;
      }
    }
    if (!staged && !done && planned - claimed_at >= 2) stage();
    if (have) {
      c = {it_lo,  it_hi, it_c0, it_width, next_e, min(chunk, it_hi_e - next_e),
           kValid | (next_e == it_lo_e ? kFirst : 0), it_inv};
      next_e += c.n;
      if (next_e == it_hi_e) {
        c.flags |= kLast;
        have = false;
      }
    }
    if (lane == 0) ring.desc[planned % kDescs] = c;
    ++planned;
  };

  // the sender and weight of edge `lane` of chunk g (set g & 1), loaded
  // two steps before the chunk is issued (set is a constant at every call)
  int pf_snd0 = 0, pf_snd1 = 0;
  float pf_w0 = 0.f, pf_w1 = 0.f;
  auto prefetch = [&](int g, int set) {
    const Chunk c = ring.desc[g % kDescs];
    if ((c.flags & kValid) && lane < c.n) {
      if (set) {
        pf_snd1 = __ldcs(snd + c.ea + lane);
        pf_w1 = __ldcs(w + c.ea + lane);
      } else {
        pf_snd0 = __ldcs(snd + c.ea + lane);
        pf_w0 = __ldcs(w + c.ea + lane);
      }
    }
  };
  // chunk g into stage g % kStages: weights and row gathers
  auto issue = [&](int g, int set) {
    const Chunk c = ring.desc[g % kDescs];
    if (c.flags & kValid) {
      const int s = g % kStages;
      const int width = c.width;
      const uint32_t bar = smem_addr(&ring.bar[s]);
      if (kMode == kCopyBulk) {
        if (lane == 0) mbar_expect_tx(bar, 4u * width * c.n);
        __syncwarp();
      }
      float* stage = rows + s * stage_floats;
      const int pf_snd = set ? pf_snd1 : pf_snd0;
      if (lane < c.n) {
        ring.w[s][lane] = set ? pf_w1 : pf_w0;
        const float* src = feat + (int64_t)pf_snd * d + c.c0;
        if (kMode == kCopyBulk) {
          bulk_load(smem_addr(stage + lane * width), src, 4u * width, bar);
        } else if (kMode == kCopy4) {
          for (int j = 0; j < width; ++j) cp_async4(smem_addr(stage + lane * width + j), src + j);
        }
      }
      if (kMode == kCopy16) {
        // lanes on consecutive 16-byte pieces of the chunk's rows: a round
        // copies 32 / q whole rows of q pieces, lane l piece l % q of row
        // l / q (divided by multiplying with inv: l < 32, q <= 8)
        const int q = width / 4, per = (32 * c.inv) >> 16;
        const int le = (lane * c.inv) >> 16, j = 4 * (lane - le * q);
        for (int e0 = 0; e0 < c.n; e0 += per) {
          const int e = e0 + le;
          const int row = shfl(pf_snd, e & 31);
          if (le < per && e < c.n) {
            cp_async16(smem_addr(stage + e * width + j), feat + (int64_t)row * d + c.c0 + j);
          }
        }
      }
    }
    if (kMode != kCopyBulk) cp_async_commit();
  };

  if (kMode == kCopyBulk && lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&ring.bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int g = 0; g <= kStages + 1; ++g) plan();
  __syncwarp();
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    prefetch(g, g & 1);
    issue(g, g & 1);
  }
  prefetch(kStages - 1, (kStages - 1) & 1);
  prefetch(kStages, kStages & 1);

  // the adds: this lane's columns of the current segment
  float acc[kPerLane];
  int c0 = 0, width = 0, k = 0, kb = 0, seg_end = 0, seg_row_ = 0, seg_flags = 0, hi = 0;
  SegBatch cur, nxt;
  auto take = [&]() {  // segment k's end, row and flags from the batch
    seg_end = shfl(cur.end, k - kb);
    seg_row_ = shfl(cur.row, k - kb);
    seg_flags = shfl(cur.flags, k - kb);
  };
  auto flush = [&]() {  // segment k done: write it, start the next
    if (seg_flags & 2) {
      if (seg_flags & 1) {
        float* dst = partial + (int64_t)k * d + c0 + lane;
#pragma unroll
        for (int v = 0; v < kPerLane; ++v) {
          if (lane + 32 * v < width) dst[32 * v] = acc[v];
        }
      } else {
        float* dst = out + (int64_t)seg_row_ * d + c0 + lane;
#pragma unroll
        for (int v = 0; v < kPerLane; ++v) {
          if (lane + 32 * v < width) __stcs(dst + 32 * v, add_rn(0.f, acc[v]));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) acc[v] = 0.f;
  };
#pragma unroll
  for (int v = 0; v < kPerLane; ++v) acc[v] = 0.f;
  // step g: issue chunk g + kStages - 1, load chunk g + kStages + 1's
  // senders and weights, plan chunk g + kStages + 2, add chunk g; par is
  // g & 1
  int g_next = 0;
  auto step = [&](int g, int par) {
    const Chunk c = ring.desc[g % kDescs];
    if (!(c.flags & kValid)) return false;
    issue(g + kStages - 1, (kStages - 1 + par) & 1);
    prefetch(g + kStages + 1, (kStages + 1 + par) & 1);
    plan();
    const int s = g % kStages;
    if (c.flags & kFirst) {  // a new item: its slice and first segments
      c0 = c.c0;
      width = c.width;
      hi = c.hi;
      k = kb = c.lo;
      cur.load(seg_beg, seg_row, kb, hi, n_seg);
      cur.finish(block_active, row_block);
      nxt.load(seg_beg, seg_row, kb + 32, hi, n_seg);
      take();
    }
    if (kMode == kCopyBulk) {
      mbar_wait(smem_addr(&ring.bar[s]), (g / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();
    }
    __syncwarp();
    float* stage = rows + s * stage_floats;
    if (kPerLane == 1) {
      // rows of at most 32 columns: every lane multiplies the stage's
      // floats by their edge's weight in place (in 4-float pieces where
      // width % 4 == 0), so the adds below take one load an edge
      if (width % 4 == 0) {
        float4* st = reinterpret_cast<float4*>(stage);
        for (int p = lane; p < c.n * (width / 4); p += 32) {
          const float wv = ring.w[s][(p * c.inv) >> 16];
          float4 v = st[p];
          v = {mul_rn(wv, v.x), mul_rn(wv, v.y), mul_rn(wv, v.z), mul_rn(wv, v.w)};
          st[p] = v;
        }
      } else {
        for (int f = lane; f < c.n * width; f += 32) {
          stage[f] = mul_rn(ring.w[s][(f * c.inv) >> 16], stage[f]);
        }
      }
      __syncwarp();
    }
    // the chunk's edges, in runs that end at a segment's end
    for (int i = 0; i < c.n;) {
      if (c.ea + i == seg_end) {
        flush();
        if (++k - kb == 32) {
          kb = k;
          cur = nxt;
          cur.finish(block_active, row_block);
          nxt.load(seg_beg, seg_row, kb + 32, hi, n_seg);
        }
        take();
      }
      const int run = min(c.n - i, seg_end - (c.ea + i));
      const float* x = stage + i * width + lane;
      if (kPerLane == 1) {  // the products: one chain a column
        if (lane < width) {
#pragma unroll 8
          for (int j = 0; j < run; ++j, x += width) acc[0] = add_rn(acc[0], *x);
        }
      } else {
        const float* ws = ring.w[s] + i;
#pragma unroll 4
        for (int j = 0; j < run; ++j) {
          const float wv = ws[j];
#pragma unroll
          for (int v = 0; v < kPerLane; ++v) {
            if (lane + 32 * v < width) {
              acc[v] = add_rn(acc[v], mul_rn(wv, x[j * width + 32 * v]));
            }
          }
        }
      }
      i += run;
    }
    if (c.flags & kLast) flush();
    __syncwarp();
    return true;
  };
  // one call site of step, unrolled so that par is a constant there
  for (bool more = true; more;) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      if (more) more = step(g_next++, par);
    }
  }
}

// One thread per element of a listed row of two or more segments (rows[j]).
__global__ void __launch_bounds__(kThreads)
combine_cols(const float* __restrict__ partial, const int* __restrict__ row_ids,
             const int* __restrict__ row_seg, const int* __restrict__ rows,
             const int* __restrict__ block_active, float* __restrict__ out, int64_t n_multi,
             int d, int row_block) {
  const int64_t j = thread_item(n_multi * d);
  if (j < 0) return;
  const int64_t i = rows[j / d], v = row_ids[i];
  const int c = (int)(j % d);
  if (row_active(block_active, (int)v, row_block)) {
    out[v * d + c] = sum_segments(partial, row_seg, i, d, c);
  }
}

}  // namespace

// D == 1.  partial: scratch of n_seg floats, written and read only when
// n_partial > 0 (may be null otherwise).  block_active may be null (all
// on).  The tile tables (tile_beg, tile_end, multi_rows: kernels/csr.py
// TileTables); tile_cap is the most edges and tile_segs the most segments
// of any tile (at most kThreads, else cudaErrorInvalidValue).
extern "C" int gas_gather_combine(const void* feat, const void* w, const void* snd,
                                  const void* row_ids, const void* row_seg,
                                  const void* seg_beg, const void* seg_row,
                                  const void* block_active, const void* tile_beg,
                                  const void* tile_end, const void* multi_rows,
                                  void* partial, void* out, int n_rows, int row_block,
                                  int n_tiles, int n_partial, int n_multi, int tile_cap,
                                  int tile_segs, void* stream) {
  if (n_rows <= 0) return 0;
  if (tile_segs > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, (size_t)n_rows * sizeof(float), s);
  const int* ba = static_cast<const int*>(block_active);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (n_tiles > 0) {
    segments_d1<<<n_tiles, kThreads, (size_t)tile_cap * sizeof(float), s>>>(
        static_cast<const float*>(feat), static_cast<const float*>(w),
        static_cast<const int*>(snd), static_cast<const int*>(seg_beg),
        static_cast<const int*>(seg_row), static_cast<const int*>(tile_beg),
        static_cast<const int*>(tile_end), ba, p, o, n_partial, row_block);
  }
  if (n_multi > 0) {
    combine_d1<<<n_multi, kThreads, 0, s>>>(p, static_cast<const int*>(row_ids),
                                            static_cast<const int*>(row_seg),
                                            static_cast<const int*>(multi_rows), ba, o,
                                            row_block);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
using ColsKernel = void (*)(const float*, const float*, const int*, const int*, const int*,
                            const int4*, const int*, float*, float*, int*, int, int, int, int,
                            int);

// (no kPerLane = 2: ptxas spilled it; slices of 33-64 columns take 4;
// kCopy16 takes rows of at most 32 columns)
template <int kMode>
ColsKernel<kMode> cols_kernel(int max_width) {
  if constexpr (kMode == kCopy16) {
    return items_cols<kMode, 1>;
  } else {
    if (max_width <= 32) return items_cols<kMode, 1>;
    if (max_width <= 128) return items_cols<kMode, 4>;
    if (max_width <= 256) return items_cols<kMode, 8>;
    return items_cols<kMode, 16>;
  }
}

// As many blocks as fit on the device at once (the warps claim the items).
template <int kMode>
int launch_cols(const float* feat, const float* w, const int* snd, const int* seg_beg,
                const int* seg_row, const int4* items, const int* ba, float* p, float* o,
                int* counter, int n_items, int n_seg, int d, int stage_floats, int row_block,
                cudaStream_t s) {
  const ColsKernel<kMode> kernel = cols_kernel<kMode>(std::min(d, 32 * kMaxPerLane));
  const int smem =
      (int)(kColWarps * (sizeof(WarpRing) + (size_t)kStages * stage_floats * sizeof(float)));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kColWarps, smem);
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n_items + kColWarps - 1) / kColWarps;
  const int grid = (int)std::min<int64_t>(blocks, (int64_t)std::max(per_sm, 1) * sms);
  kernel<<<grid, 32 * kColWarps, smem, s>>>(feat, w, snd, seg_beg, seg_row, items, ba, p, o,
                                            counter, n_items, n_seg, d, stage_floats, row_block);
  return 0;
}

// d >= 2.  The column items (items [n_items][8], multi_rows:
// kernels/csr.py ColumnItems; no slice wider than 32 * kMaxPerLane);
// stage_floats (a multiple of 4) is the floats a ring stage holds at the
// widest slice.  partial: scratch of n_seg * d floats, written and read
// only when n_multi > 0 (may be null otherwise).  counter: scratch of one
// int.  block_active may be null (all on).  copy: -1 chooses by the shape
// (where d is a multiple of 4 and feat is 16-byte aligned, 16-byte
// cp.async pieces for rows of at most kPieceRowBytes and cp.async.bulk
// for wider ones; else 4-byte cp.async), 0-2 forces a CopyMode (the
// 16-byte modes need that alignment, and kCopy16 rows of at most
// kPieceRowBytes, else cudaErrorInvalidValue).
extern "C" int gas_gather_combine_cols(const void* feat, const void* w, const void* snd,
                                       const void* row_ids, const void* row_seg,
                                       const void* seg_beg, const void* seg_row,
                                       const void* block_active, const void* items,
                                       const void* multi_rows, void* partial, void* counter,
                                       void* out, int n_rows, int n_seg, int d, int row_block,
                                       int n_items, int n_multi, int stage_floats, int copy,
                                       void* stream) {
  if (n_rows <= 0) return 0;
  const bool aligned = d % 4 == 0 && (reinterpret_cast<uintptr_t>(feat) & 15) == 0;
  if (copy < 0) copy = !aligned ? kCopy4 : 4 * d <= kPieceRowBytes ? kCopy16 : kCopyBulk;
  if (d < 2 || stage_floats % 4 != 0 || copy > kCopy4 || (copy != kCopy4 && !aligned) ||
      (copy == kCopy16 && 4 * d > kPieceRowBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(float), s);
  const int* ba = static_cast<const int*>(block_active);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (n_items > 0) {
    const float* f = static_cast<const float*>(feat);
    const float* wt = static_cast<const float*>(w);
    const int* sn = static_cast<const int*>(snd);
    const int* sb = static_cast<const int*>(seg_beg);
    const int* sr = static_cast<const int*>(seg_row);
    const int4* it = static_cast<const int4*>(items);
    int* ctr = static_cast<int*>(counter);
    const int rc =
        copy == kCopyBulk
            ? launch_cols<kCopyBulk>(f, wt, sn, sb, sr, it, ba, p, o, ctr, n_items, n_seg, d,
                                     stage_floats, row_block, s)
        : copy == kCopy16 ? launch_cols<kCopy16>(f, wt, sn, sb, sr, it, ba, p, o, ctr, n_items,
                                                 n_seg, d, stage_floats, row_block, s)
                          : launch_cols<kCopy4>(f, wt, sn, sb, sr, it, ba, p, o, ctr, n_items,
                                                n_seg, d, stage_floats, row_block, s);
    if (rc != 0) return rc;
  }
  if (n_multi > 0) {
    combine_cols<<<thread_grid((int64_t)n_multi * d), kThreads, 0, s>>>(
        p, static_cast<const int*>(row_ids), static_cast<const int*>(row_seg),
        static_cast<const int*>(multi_rows), ba, o, n_multi, d, row_block);
  }
  return static_cast<int>(cudaGetLastError());
}
