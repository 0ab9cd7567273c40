// K5: FlashAttention-2 forward with GQA, causal and sliding-window masks,
// for sm_90a; inputs f32 or bf16, math in f32.  This file's SIMT kernel
// serves f32 at every head dim and bf16 at d ∈ {16, 32}; bf16 at
// d ∈ {64, 128} (the LM path) goes to the tensor-core kernel in
// flash_attention_sm90.cu, through the same entry point below.
//
//   out[b, s, h] = Σ_t softmax_t(q[b,s,h]·k[b,t,h/G] / √d) v[b,t,h/G]
//
// over the keys t with t < T, t ≤ s when causal, and t > s − W when a
// window W is set; a row with no key in its mask comes out as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py: flash_attention_pallas (+ _kernel).  The TPU grid is
// (b, h, q block, kv block) with the kv axis walked in order and the
// running softmax (m, l, acc) carried in VMEM scratch across grid steps.
// Blocks on the card run in no order, so here one block owns one
// (b, h, 64-row query tile) and walks its kv tiles in a loop; m, l and the
// accumulator live in registers the whole time.
//
// The loop starts at the first kv tile that the window reaches (the
// tile holding q0 − W + 1) and, when causal, stops after the diagonal
// tile: at S = 32768 and W = 4096 a query tile reads 65 of up to 512
// kv tiles.
//
// Tiles: 64 queries × 64 keys, 256 threads.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns query rows 4·ty … 4·ty + 3 of both products: scores of
// keys tx + 16·j (j < 4), and D/16 output columns.  So a row's max and sum
// are reduced over the 16 lanes of a half warp by shuffles, with no
// shared-memory round trip.  Q, K, V and P tiles sit in shared memory as
// f32 (rows of Q and K padded by 4 floats so that 16-byte reads of 16
// consecutive rows fall on distinct banks); products are f32 FMAs, so f32
// inputs keep full f32 accuracy (TF32 tensor cores would not).
//
// Bound on the H100: operations — 4·d flops per (query, key) pair inside
// the mask, per head, at 989 TFLOP/s (the bf16 tensor-core rate the
// products could use); the bytes (q, k, v read once, out written once) are
// far below that at the prefill shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

template <int D>
struct Tile {
  static constexpr int kQS = D + 4;       // Q row stride (floats)
  static constexpr int kKS = D + 4;       // K row stride
  static constexpr int kVS = D;           // V row stride
  static constexpr int kPS = kBK + 4;     // P row stride
  static constexpr int kDC = D / 16;      // output columns per thread
  static constexpr bool kVec = kDC % 4 == 0;
  static constexpr size_t kSmemFloats =
      (size_t)kBQ * kQS + (size_t)kBK * kKS + (size_t)kBK * kVS + (size_t)kBQ * kPS;
  // column c (< kDC) of this thread's output columns
  __device__ static int col(int tx, int c) {
    return kVec ? ((c / 4) * 16 + tx) * 4 + (c % 4) : tx + 16 * c;
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of a [n_rows, stride] view (row r at
// base + r·row_step), zeros past n_rows, into f32 shared memory.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* base,
                                          int64_t row_step, int row0, int n_rows) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int k = (c % kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = load4(base + (int64_t)(row0 + r) * row_step + k);
    *reinterpret_cast<float4*>(dst + r * dst_stride + k) = v;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int S, int T_len, int H, int KV, int causal, int window,
          float scale) {
  using C = Tile<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * C::kQS;
  float* Vs = Ks + kBK * C::kKS;
  float* Ps = Vs + kBK * C::kVS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t q_step = (int64_t)H * D, kv_step = (int64_t)KV * D;
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * T_len * KV + kvh) * D;
  const T* vb = v + ((int64_t)b * T_len * KV + kvh) * D;

  load_tile<D>(Qs, C::kQS, qb, q_step, q0, S);

  float m[4], l[4], acc[4][C::kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kDC; ++c) acc[i][c] = 0.f;
  }

  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q0 + kBQ) : T_len;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(Ks, C::kKS, kb, kv_step, kt, T_len);
    load_tile<D>(Vs, C::kVS, vb, kv_step, kt, T_len);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * C::kQS + d0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * C::kKS + d0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool valid[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + tx + 16 * j;
        valid[j] = kpos < T_len && (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * C::kPS + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 2
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * C::kPS + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j0 + jj) * C::kVS;
        float vc[C::kDC];
        if constexpr (C::kVec) {
#pragma unroll
          for (int g = 0; g < C::kDC / 4; ++g) {
            const float4 w = *reinterpret_cast<const float4*>(vrow + (g * 16 + tx) * 4);
            vc[4 * g] = w.x;
            vc[4 * g + 1] = w.y;
            vc[4 * g + 2] = w.z;
            vc[4 * g + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < C::kDC; ++c) vc[c] = vrow[tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < C::kDC; ++c) acc[i][c] = fmaf(p, vc[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((int64_t)b * S + qpos) * q_step + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < C::kDC; ++c) store1(orow + C::col(tx, c), acc[i][c] / denom);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int H, int KV, int causal, int window, float scale, cudaStream_t s) {
  const size_t smem = Tile<D>::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<D, T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, T_len, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

// bf16 at d 64 and 128 never comes here (flash_attention_sm90.cu).
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
             int H, int KV, int d, int causal, int window, float scale, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (d) {
    case 16: return launch<16, T>(q, k, v, out, B, S, T_len, H, KV, causal, window, scale, s);
    case 32: return launch<32, T>(q, k, v, out, B, S, T_len, H, KV, causal, window, scale, s);
    case 64:
      if constexpr (kF32) return launch<64, T>(q, k, v, out, B, S, T_len, H, KV, causal, window, scale, s);
      break;
    case 128:
      if constexpr (kF32) return launch<128, T>(q, k, v, out, B, S, T_len, H, KV, causal, window, scale, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace repro_torch {
int flash_attention_bf16_sm90(const void* q, const void* k, const void* v, void* out, int B,
                              int S, int T_len, int H, int KV, int d, int causal, int window,
                              float scale, cudaStream_t s);
}  // namespace repro_torch

// q [B, S, H, d], k and v [B, T, KV, d] → out [B, S, H, d], all contiguous
// and of one dtype (bf16 != 0: bf16, else f32).  d ∈ {16, 32, 64, 128};
// H a multiple of KV; window <= 0: no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int S, int T_len, int H, int KV, int d, int causal,
                               int window, float scale, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && (d == 64 || d == 128)) {
    return repro_torch::flash_attention_bf16_sm90(q, k, v, out, B, S, T_len, H, KV, d, causal,
                                                  window, scale, s);
  }
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, S, T_len, H, KV, d, causal, window,
                                        scale, s)
              : dispatch<float>(q, k, v, out, B, S, T_len, H, KV, d, causal, window, scale, s);
}
