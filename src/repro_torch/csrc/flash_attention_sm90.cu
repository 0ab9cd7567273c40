// K5 on bf16 at d ∈ {64, 128}: the FlashAttention forward for Hopper, for
// sm_90a, on tensor cores (wgmma) with TMA loads.
//
//   out[b, s, h] = Σ_t softmax_t(q[b,s,h]·k[b,t,h/G] / √d) v[b,t,h/G]
//
// over the keys t with t < T, t ≤ s when causal, and t > s − W when a
// window W is set; a row with no key in its mask comes out as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py: flash_attention_pallas (+ _kernel) for bf16 inputs at
// head dims 64 and 128; f32 inputs, and bf16 at d 16 and 32, stay on the
// SIMT kernel in flash_attention.cu, whose entry point dispatches here.
//
// Bound on the H100: operations — 4·d flops per (query, key) pair inside
// the mask, per head, at 989 TFLOP/s in the bf16 tensor cores; the bytes
// (q, k, v read once, out written once) are far below that at the prefill
// shape.  What the design does about it (the FlashAttention-3 forward
// pattern, without its ping-pong scheduling of the two warpgroups):
//   - one block owns one (b, h, 128-query tile): a producer warpgroup and
//     two consumer warpgroups of 64 query rows each (384 threads); the
//     producer gives back its registers (setmaxnreg 24) and the consumers
//     take them (240), which the overlap below needs: S, P and O live at
//     once (in a 288-thread block without setmaxnreg, ptxas stopped near
//     168 registers, serialised the wgmmas and spilled);
//   - the producer's one thread issues TMA loads (cp.async.bulk.tensor,
//     4-D tensor maps over q [B, S, H, d] and k, v [B, T, KV, d] in their
//     own strides, so nothing is transposed on the host; rows past S or T
//     arrive as zeros) of the Q tile once and of 128-key K and V tiles
//     into a 3-stage shared-memory ring, each stage with a "full" mbarrier
//     (transaction bytes) and an "empty" one (one arrival a consumer warp);
//     a tile row of d bf16 is cut into 64-column blocks, each row of a
//     block 128 bytes in the 128-byte swizzle that the wgmma descriptors
//     read (at d 128: Q 32 KB + 3 × (K 32 KB + V 32 KB) = 224 KB);
//   - S = Q·Kᵀ: wgmma m64n128k16 with both operands K-major in shared
//     memory and f32 accumulators, d/16 of them a tile;
//   - the online softmax runs in registers in the accumulator layout (a
//     thread holds two rows; a row's max is reduced over the 4 lanes that
//     share it, its sum is kept per lane and reduced once at the end), in
//     the log2 domain: one FFMA and one ex2.approx an element;
//   - P is rounded to bf16 in registers and is the register A operand of
//     O += P·V (wgmma m64n{d}k16, V from shared memory as the MN-major,
//     transposed, B operand), 8 of them a tile; α-rescaling, l and the
//     final O / max(l, 1e-30) stay in f32;
//   - across kv tiles a warpgroup issues tile i's Q·Kᵀ and tile i-1's P·V
//     together and runs tile i's softmax while the tensor cores do that
//     P·V (FA3's intra-warpgroup overlap);
//   - the kv loop starts at the window's first tile and stops after the
//     diagonal; only a tile that crosses the diagonal, the window's edge or
//     T (for a warpgroup's 64 rows) applies the mask, interior tiles skip it.
// P's rounding to bf16 is the one change of arithmetic against the SIMT
// kernel and the plain version (both f32 throughout); the bar stays one
// bf16 ulp (2^-7) of the largest output.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;              // query rows a block
constexpr int kBN = 128;              // keys a kv tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;     // two warpgroups, after the producer warpgroup
constexpr int kThreads = 128 + 32 * kConsumerWarps;
constexpr int kCols = 64;             // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets into the (1024-aligned) dynamic shared memory.
template <int D>
struct Layout {
  static constexpr int kQBytes = kBM * D * 2;     // [D/64][kBM][64] bf16
  static constexpr int kKVBytes = kBN * D * 2;    // [D/64][kBN][64] bf16
  static constexpr int kK = kQBytes;              // stage st: + st·2·kKVBytes; V after K
  static constexpr int kBar = kQBytes + kStages * 2 * kKVBytes;
  // q_full, kv_full[kStages], kv_empty[kStages]; 1024 bytes of alignment slack
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands:
// lbo unused (16), sbo = 1024 (8 rows of 128 bytes).  MN-major: lbo = the
// distance between 64-column blocks, sbo = 1024 (8 rows along K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] · B[128 x 16]ᵀ, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] · B[16 x 128], A in registers (bf16 pairs), B MN-major
// in shared memory (the transposed B that 16-bit types allow).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] · B[16 x 64], A in registers (bf16 pairs), B MN-major
// in shared memory (the transposed B that 16-bit types allow).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
               int S, int T_len, int H, int KV, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int kColBlocks = D / kCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t kv_full = q_full + 8;                  // + 8 · stage
  const uint32_t kv_empty = kv_full + 8 * kStages;      // + 8 · stage

  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kBM;  // long kv loops first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
  const int k_end = causal ? min(T_len, q0 + kBM) : T_len;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBN - 1) / kBN : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load(base + cb * kBM * kRowBytes, &q_map, cb * kCols, h, q0, b, q_full);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(kv_empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t full = kv_full + 8 * st;
        const uint32_t k_dst = base + L::kK + st * 2 * L::kKVBytes;
        const int kt = k_begin + i * kBN;
        mbar_expect_tx(full, 2 * L::kKVBytes);
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load(k_dst + cb * kBN * kRowBytes, &k_map, cb * kCols, kvh, kt, b, full);
          tma_load(k_dst + L::kKVBytes + cb * kBN * kRowBytes, &v_map, cb * kCols, kvh, kt, b,
                   full);
        }
      }
    }
    return;
  }

  // The consumers take the registers the producer gave back.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cwarp = warp - 4;
  // A consumer thread holds rows qa and qb = qa + 8 of its warpgroup's 64,
  // columns 8j + c and 8j + c + 1 of every 8-column chunk j.
  const int wg = cwarp >> 2;
  const int qlo = q0 + wg * 64;
  const int qa = qlo + (cwarp & 3) * 16 + (lane >> 2), qb = qa + 8;
  const int c = 2 * (lane & 3);
  const uint32_t q_base = base + wg * 64 * kRowBytes;
  const auto k_smem = [&](int i) { return base + L::kK + (i % kStages) * 2 * L::kKVBytes; };

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float s[64];
  uint32_t p[kBN / 16][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // S = Q·Kᵀ of tile i, 64 × 128, f32: issued and committed
  const auto issue_qk = [&](int i) {
    const uint32_t k_base = k_smem(i);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled row
      wgmma_ss_n128(s, smem_desc(q_base + (kk / 4) * kBM * kRowBytes + col, 16, 1024),
                    smem_desc(k_base + (kk / 4) * kBN * kRowBytes + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P·V of tile i: issued and committed
  const auto issue_pv = [&](int i) {
    const uint32_t v_base = k_smem(i) + L::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t vd = smem_desc(v_base + kk * 16 * kRowBytes, kBN * kRowBytes, 1024);
      if constexpr (D == 128) {
        wgmma_rs_n128(o, p[kk], vd);
      } else {
        wgmma_rs_n64(o, p[kk], vd);
      }
    }
    wgmma_commit();
  };
  // The online softmax of tile i's scores, in the log2 domain: s becomes
  // P (f32), m and l move on, and the factors O must be rescaled by are
  // returned.  Only a tile that crosses T, the diagonal or the window's
  // edge for these 64 rows applies the mask.
  const auto softmax = [&](int i, float& alpha_a, float& alpha_b) {
    const int kt = k_begin + i * kBN;
    const bool edge = kt + kBN > T_len || (causal && kt + kBN - 1 > qlo) ||
                      (window > 0 && kt <= qlo + 63 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const int kpos = kt + 8 * (j / 4) + c + (j & 1);
        const int qpos = (j & 2) ? qb : qa;
        const bool ok = kpos < T_len && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[j] = ok ? s[j] : -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float new_a = fmaxf(m_a, mx_a * scale_log2), new_b = fmaxf(m_b, mx_b * scale_log2);
    // a row that has seen no key yet keeps -inf; subtract 0 instead
    const float sub_a = new_a == -INFINITY ? 0.f : new_a;
    const float sub_b = new_b == -INFINITY ? 0.f : new_b;
    alpha_a = exp2_approx(m_a - sub_a);
    alpha_b = exp2_approx(m_b - sub_b);
    m_a = new_a;
    m_b = new_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = exp2_approx(fmaf(s[4 * j], scale_log2, -sub_a));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -sub_a));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -sub_b));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -sub_b));
      sum_a += s[4 * j] + s[4 * j + 1];
      sum_b += s[4 * j + 2] + s[4 * j + 3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
  };
  // P in bf16: the A fragments of 16-key steps are the accumulator's
  // 8-column chunks 2kk and 2kk + 1
  const auto to_bf16 = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  const auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty + 8 * (i % kStages));
  };

  // Software pipeline across kv tiles: tile i's S = Q·Kᵀ and tile i-1's
  // O += P·V are issued together, and tile i's softmax runs while the
  // tensor cores do tile i-1's P·V.
  mbar_wait(q_full, 0);
  float alpha_a, alpha_b;
  if (n_tiles > 0) {
    mbar_wait(kv_full, 0);
    fence_regs(s);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0, alpha_a, alpha_b);  // O is still zero: nothing to rescale
    to_bf16();
  }
  for (int i = 1; i < n_tiles; ++i) {
    mbar_wait(kv_full + 8 * (i % kStages), (i / kStages) & 1);
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
    issue_qk(i);
    issue_pv(i - 1);
    wgmma_wait<1>();  // S of tile i is in
    fence_regs(s);
    softmax(i, alpha_a, alpha_b);
    wgmma_wait<0>();  // O of tile i-1 is in
    fence_regs(o);
    release(i - 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
    to_bf16();
  }
  if (n_tiles > 0) {
    fence_regs(o);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    release(n_tiles - 1);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const int64_t row_step = (int64_t)H * D;
  __nv_bfloat16* out_a = out + ((int64_t)b * S + qa) * row_step + (int64_t)h * D + c;
  __nv_bfloat16* out_b = out_a + 8 * row_step;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (qa < S) {
      *reinterpret_cast<uint32_t*>(out_a + 8 * j) =
          pack_bf16(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    }
    if (qb < S) {
      *reinterpret_cast<uint32_t*>(out_b + 8 * j) =
          pack_bf16(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once in the driver that
// the process has loaded (no link against libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 4-D map over a contiguous bf16 [B, rows, heads, d] tensor whose box is
// 64 columns × 1 head × 128 rows × 1 batch, in the 128-byte swizzle;
// reads past `rows` fill zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)rows * heads * d * 2};
  const cuuint32_t box[4] = {kCols, 1, kBM, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  static_assert(kBM == kBN, "one box shape serves q, k and v");
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, B, S, H, D) || !tensor_map(&k_map, k, B, T_len, KV, D) ||
      !tensor_map(&v_map, v, B, T_len, KV, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  flash_fwd_sm90<D><<<grid, kThreads, smem, s>>>(q_map, k_map, v_map,
                                                 static_cast<__nv_bfloat16*>(out), S, T_len,
                                                 H, KV, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro_torch {

// bf16 q [B, S, H, d], k and v [B, T, KV, d] → out [B, S, H, d], all
// contiguous and 16-byte aligned; d ∈ {64, 128}; H a multiple of KV;
// window <= 0: no window.
int flash_attention_bf16_sm90(const void* q, const void* k, const void* v, void* out, int B,
                              int S, int T_len, int H, int KV, int d, int causal, int window,
                              float scale, cudaStream_t s) {
  if (T_len <= 0) {
    cudaMemsetAsync(out, 0, (size_t)B * S * H * d * sizeof(__nv_bfloat16), s);
    return (int)cudaGetLastError();
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  switch (d) {
    case 64: return launch<64>(q, k, v, out, B, S, T_len, H, KV, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, out, B, S, T_len, H, KV, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch
