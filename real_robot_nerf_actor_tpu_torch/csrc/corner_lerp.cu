// Trilinear corner lerp over corner-expanded gather rows.
//
// Replaces the JAX package's `ops/lerp_pallas.py` (`corner_lerp`, the Pallas
// kernel `_lerp_kernel`). For rows (M, 8C) and the weight-mask products
// w (8, M) fp32,
//
//   out[m, c] = sum_k rows[m, k*C + c] * w[k, m],   k = 0..7
//
// summed in fp32 in the gather kernel's exact order (resnetfc_int8.cu,
// `load_zi<true>`): __fmul_rn(r0, w0), then seven __fmaf_rn in corner order,
// rounded once to the rows' dtype. So the gather-fused serving path equals
// the unfused one bit for bit.
//
// What bounds it on an H100: 16 bytes of bf16 rows (32 of fp32) and 32
// bytes of weights read and 2 (4) bytes written per output element against
// 15 flops: memory, 3.35 TB/s.
//
// Design: the vector path gives each thread one 16-byte chunk of an output
// row (8 bf16 or 4 fp32 channels): eight 16-byte loads, one per corner, the
// row's eight weights, the sums in fp32 registers, one 16-byte store. With
// C = 64 bf16 a row is 8 neighbouring threads, so a warp reads whole
// 128-byte segments of four rows. Each row is read once, so its loads are
// streaming (__ldcs, evict first): they still hit the L2 where the gather
// before the lerp left the rows, and leave the L2 to the weights and the
// output. Offsets are 64-bit. Rows whose channels
// are not whole 16-byte chunks, or a base that is not 16-byte aligned, take
// the scalar path of the same kernel source: one output element a thread.
#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&x)[Vec<T>::n]);
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&x)[Vec<T>::n]);
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float (&x)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16_rn(x[2 * i]), __float2bfloat16_rn(x[2 * i + 1]));
  return v;
}
template <>
__device__ __forceinline__ uint4 pack<float>(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}

// one 16-byte chunk of an output row a thread: chunks = M * C / V
template <typename T>
__global__ void __launch_bounds__(NT)
lerp_vector(const T* __restrict__ rows, const float* __restrict__ w, T* __restrict__ out,
            long long M, int C) {
  constexpr int V = Vec<T>::n;
  const int per_row = C / V;
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= M * per_row) return;
  const long long m = i / per_row;
  const int c = static_cast<int>(i - m * per_row) * V;
  const T* src = rows + m * 8 * C + c;
  uint4 v[8];
  float wk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = __ldcs(reinterpret_cast<const uint4*>(src + k * C));
    wk[k] = __ldg(w + k * M + m);
  }
  float acc[V], x[V];
  unpack<T>(v[0], x);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(x[j], wk[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    unpack<T>(v[k], x);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fmaf_rn(x[j], wk[k], acc[j]);
  }
  *reinterpret_cast<uint4*>(out + m * C + c) = pack<T>(acc);
}

// one output element a thread: any C, any alignment
template <typename T>
__global__ void __launch_bounds__(NT)
lerp_scalar(const T* __restrict__ rows, const float* __restrict__ w, T* __restrict__ out,
            long long M, int C) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= M * C) return;
  const long long m = i / C;
  const int c = static_cast<int>(i - m * C);
  const T* src = rows + m * 8 * C + c;
  float acc = __fmul_rn(to_f32(src[0]), w[m]);
#pragma unroll
  for (int k = 1; k < 8; ++k) acc = __fmaf_rn(to_f32(src[k * C]), w[k * M + m], acc);
  out[i] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* rows, const void* w, void* out, long long M, int C, bool vector,
           cudaStream_t s) {
  const long long n = vector ? M * (C / Vec<T>::n) : M * C;
  const unsigned blocks = static_cast<unsigned>((n + NT - 1) / NT);
  if (vector)
    lerp_vector<T><<<blocks, NT, 0, s>>>(static_cast<const T*>(rows),
                                         static_cast<const float*>(w), static_cast<T*>(out),
                                         M, C);
  else
    lerp_scalar<T><<<blocks, NT, 0, s>>>(static_cast<const T*>(rows),
                                         static_cast<const float*>(w), static_cast<T*>(out),
                                         M, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (M, 8C) of `dtype` (0 fp32, 1 bf16), w (8, M) fp32, out (M, C) of
// `dtype`, all contiguous. vector: 1 for the 16-byte path, which needs C a
// whole number of 16-byte chunks and rows and out 16-byte aligned.
extern "C" int corner_lerp_fwd(const void* rows, const void* w, void* out, int M, int C,
                               int dtype, int vector, void* stream) {
  if (M < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const int size = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 2 : 0;
  if (size == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vector && ((C * size) % 16 || reinterpret_cast<unsigned long long>(rows) % 16 ||
                 reinterpret_cast<unsigned long long>(out) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == kFloat32 ? launch<float>(rows, w, out, M, C, vector, s)
                           : launch<__nv_bfloat16>(rows, w, out, M, C, vector, s);
}

EXPORT_ERROR_STRING
