// K4: embedding bag — gather and bag sum over a large table, for sm_90a,
// in f32 or bf16.
//
//   out[i, :] = Σ_h table[(i % fields) · rows + ids[i, h], :]
//
// with the sum in f32 and the output in the table's dtype.  fields = 1 is
// the plain bag ([V, D] table, [N, H] ids); DLRM passes its stacked tables
// [F, V, D] as one flat table [F·V, D], rows = V and fields = F, so the
// bags of every field of every sample go through one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/
// embedding_bag.py: embedding_bag_pallas (+ _kernel).  The TPU grid walks
// batch blocks of 128 bags (padded, the pad gathering row 0) and moves each
// row from HBM to VMEM with a two-deep DMA ring, the ids scalar-prefetched.
// Here there is nothing to pad: each thread owns one bag and one 16-byte
// (f32) or 8-byte (bf16) vector of its columns, so the D/VEC threads of a
// bag read one table row as consecutive vectors (D = 64 f32: 16 threads,
// 256 bytes).  Threads load their bag's ids themselves (no scalar
// prefetch), add the rows in h order in f32 registers and store once.
//
// Order and rounding: the rows of a bag are added in h order, one
// correctly rounded f32 add each (no product, so nothing to contract), and
// bf16 rounds once, at the store.  That is the plain version's order
// (kernels/embedding_bag/ref.py), so f32 results equal it bit for bit.
//
// Addressing: the flat DLRM table holds 26 · 2^20 · 64 ≈ 1.745e9 elements;
// its byte offsets pass 2^31, so a row's offset is computed in 64 bits.
//
// Bound on the H100: bytes — B·H·D·s read from the table, B·D·s written,
// and 4·B·H bytes of ids, at 3.35 TB/s (one add per element read).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct F32Vec;
template <>
struct F32Vec<4> {
  __device__ static void add(float* acc, const float* row) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    acc[3] = __fadd_rn(acc[3], v.w);
  }
  __device__ static void store(float* out, const float* acc) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};
template <>
struct F32Vec<1> {
  __device__ static void add(float* acc, const float* row) {
    acc[0] = __fadd_rn(acc[0], __ldg(row));
  }
  __device__ static void store(float* out, const float* acc) { out[0] = acc[0]; }
};

template <int VEC>
struct Bf16Vec;
template <>
struct Bf16Vec<4> {
  __device__ static void add(float* acc, const __nv_bfloat16* row) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    acc[0] = __fadd_rn(acc[0], __low2float(a));
    acc[1] = __fadd_rn(acc[1], __high2float(a));
    acc[2] = __fadd_rn(acc[2], __low2float(b));
    acc[3] = __fadd_rn(acc[3], __high2float(b));
  }
  __device__ static void store(__nv_bfloat16* out, const float* acc) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(acc[0], acc[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(acc[2], acc[3]);
    *reinterpret_cast<uint2*>(out) = raw;
  }
};
template <>
struct Bf16Vec<1> {
  __device__ static void add(float* acc, const __nv_bfloat16* row) {
    acc[0] = __fadd_rn(acc[0], __bfloat162float(row[0]));
  }
  __device__ static void store(__nv_bfloat16* out, const float* acc) {
    out[0] = __float2bfloat16_rn(acc[0]);
  }
};

template <typename T, typename V, int VEC>
__global__ void __launch_bounds__(kThreads)
bag_sum(const T* __restrict__ table, const int* __restrict__ ids,
        T* __restrict__ out, int64_t n_bags, int bag, int d, int64_t rows,
        int fields) {
  const int per_bag = d / VEC;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_bags * per_bag) return;
  const int64_t i = t / per_bag;
  const int col = (int)(t % per_bag) * VEC;
  const int64_t base = (int64_t)(i % fields) * rows;
  const int* bag_ids = ids + i * bag;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int h = 0; h < bag; ++h) {
    const int64_t row = base + __ldg(bag_ids + h);
    V::add(acc, table + row * d + col);
  }
  V::store(out + i * d + col, acc);
}

template <typename T, typename V4, typename V1>
void launch(const void* table, const void* ids, void* out, int64_t n_bags, int bag,
            int d, int64_t rows, int fields, int vec_ok, cudaStream_t s) {
  const T* tb = static_cast<const T*>(table);
  const int* id = static_cast<const int*>(ids);
  T* o = static_cast<T*>(out);
  if (vec_ok && d % 4 == 0) {
    const int64_t n = n_bags * (d / 4);
    bag_sum<T, V4, 4><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        tb, id, o, n_bags, bag, d, rows, fields);
  } else {
    const int64_t n = n_bags * d;
    bag_sum<T, V1, 1><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        tb, id, o, n_bags, bag, d, rows, fields);
  }
}

}  // namespace

// table [fields·rows, d], ids [n_bags, bag] int32 → out [n_bags, d].
// bf16 != 0 selects bf16 table and output, else f32.  vec_ok says the
// table and output pointers are aligned for vector loads.
extern "C" int embedding_bag(const void* table, const void* ids, void* out,
                             int64_t n_bags, int bag, int d, int64_t rows,
                             int fields, int bf16, int vec_ok, void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16, Bf16Vec<4>, Bf16Vec<1>>(table, ids, out, n_bags, bag, d,
                                                  rows, fields, vec_ok, s);
  } else {
    launch<float, F32Vec<4>, F32Vec<1>>(table, ids, out, n_bags, bag, d, rows,
                                        fields, vec_ok, s);
  }
  return static_cast<int>(cudaGetLastError());
}
