// Flash attention forward for Hopper (sm_90a), head dim 64.
//
// Replaces: real_robot_nerf_actor_tpu/ops/attention_pallas.py:flash_attention
// (the Pallas kernel _flash_kernel).
//
// Computes softmax(q k^T * scale) v for q (BH, Nq, 64) and k, v (BH, Nk, 64),
// row-major and contiguous, with the same arithmetic as the TPU kernel:
// fp32 scores, keys >= Nk masked to -0.7 * FLT_MAX, an online softmax with a
// running max m, sum l and accumulator in fp32, the probabilities rounded to
// v's dtype before P.V, a guard for l == 0, and the output in q's dtype.
//
// What bounds it on this card: at the policy's shapes (2048 x 8077 and
// 2048 x 2048 with d = 64) the work is 4*Nq*Nk*64 flops against reading q, k,
// v and writing o once, some 500 flops a byte in bf16: the tensor cores, not
// memory, are the limit (989 TF/s bf16 on H100 SXM).
//
// Design: one block of 4 warps per (batch*head, 64-row q tile); k/v tiles of
// 64 keys are staged in shared memory and visited in order. In bf16 the two
// products (Q K^T and P V) run on the tensor cores through WMMA 16x16x16
// fragments with fp32 accumulation, each warp owning 16 query rows; the
// softmax runs with two threads per row. In fp32 the products are plain FMAs
// (the tensor cores would round the inputs to TF32). This first version
// neither double-buffers the k/v loads nor uses wgmma/TMA: with 32 q tiles
// the 2048-query calls fill a quarter of the 132 SMs, which a later version
// can fix by splitting the key range.
#include <mma.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;         // head dim
constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int LDT = D + 8;    // row stride (elements) of the T tiles
constexpr int LDS = BKV + 4;  // row stride (floats) of the score tile
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// rows [0, rows_valid) of a (64, D) tile from global memory, zeros beyond
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows_valid) {
  constexpr int VN = Vec<T>::n;
  constexpr int PER_ROW = D / VN;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VN;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

template <typename T>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * LDT + 2 * BKV * LDT + BQ * LDT) * sizeof(T) +
         static_cast<size_t>(BQ * LDS) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LDT;
  T* Vs = Ks + BKV * LDT;
  T* Ps = Vs + BKV * LDT;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDT);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + static_cast<size_t>(bh) * nk * D;
  const T* vb = v + static_cast<size_t>(bh) * nk * D;
  load_tile(Qs, q + (static_cast<size_t>(bh) * nq + q0) * D, nq - q0);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = tid >> 1;   // softmax / output: this thread's query row
  const int half = tid & 1;   // ... and its 32 columns
  float m_i = -INFINITY;
  float l_i = 0.f;
  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  for (int kv0 = 0; kv0 < nk; kv0 += BKV) {
    load_tile(Ks, kb + static_cast<size_t>(kv0) * D, nk - kv0);
    load_tile(Vs, vb + static_cast<size_t>(kv0) * D, nk - kv0);
    __syncthreads();

    // ---- S = Q K^T (unscaled, fp32)
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_frag;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b_frag;
#pragma unroll
      for (int f = 0; f < BKV / 16; ++f) {
        wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(a_frag, Qs + warp * 16 * LDT + kk * 16, LDT);
          wmma::load_matrix_sync(b_frag, Ks + f * 16 * LDT + kk * 16, LDT);
          wmma::mma_sync(s_frag, a_frag, b_frag, s_frag);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + f * 16, s_frag, LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d)
          s += to_f32(Qs[row * LDT + d]) * to_f32(Ks[col * LDT + d]);
        Ss[row * LDS + col] = s;
      }
    }
    __syncthreads();

    // ---- online softmax over this tile; two threads per row
    {
      const int valid = nk - kv0;
      float* srow = Ss + row * LDS + half * 32;
      float mx = MASK_VALUE;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float s = srow[c] * scale;
        if (half * 32 + c >= valid) s = MASK_VALUE;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_next = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_next);
      float lsum = 0.f;
      T* prow = Ps + row * LDT + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = expf(srow[c] - m_next);
        lsum += p;
        prow[c] = from_f32<T>(p);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      l_i = alpha * l_i + lsum;
      m_i = m_next;
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] *= alpha;
    }
    __syncthreads();

    // ---- acc += P V (P in v's dtype, fp32 accumulation)
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_frag;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b_frag;
#pragma unroll
      for (int f = 0; f < D / 16; ++f) {
        wmma::fill_fragment(o_frag, 0.f);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::load_matrix_sync(a_frag, Ps + warp * 16 * LDT + kk * 16, LDT);
          wmma::load_matrix_sync(b_frag, Vs + kk * 16 * LDT + f * 16, LDT);
          wmma::mma_sync(o_frag, a_frag, b_frag, o_frag);
        }
        // the score tile is free now: it takes this warp's P.V rows
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + f * 16, o_frag, LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();
      const float* pv = Ss + row * LDS + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] += pv[c];
    } else {
      float pv[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) pv[c] = 0.f;
      for (int kk = 0; kk < BKV; ++kk) {
        const float p = to_f32(Ps[row * LDT + kk]);
        const T* vr = Vs + kk * LDT + half * 32;
#pragma unroll
        for (int c = 0; c < 32; ++c) pv[c] += p * to_f32(vr[c]);
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] += pv[c];
    }
    __syncthreads();
  }

  if (q0 + row < nq) {
    const float inv = (l_i == 0.f) ? 1.f : 1.f / l_i;
    T* orow = o + (static_cast<size_t>(bh) * nq + q0 + row) * D + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) orow[c] = from_f32<T>(acc[c] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int nq, int nk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, nq, 64), k/v (bh, nk, 64), o (bh, nq, 64); all of one dtype,
// contiguous, 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bh, int nq, int nk, float scale,
                                   int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, bh, nq, nk, scale, s);
  if (dtype == kFloat32) return launch<float>(q, k, v, o, bh, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

EXPORT_ERROR_STRING
