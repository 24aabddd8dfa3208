// The serving renderer's whole ResnetFC forward in one kernel, W8A8 int8
// (or bf16) on the tensor cores, for Hopper (sm_90a).
//
// Replaces: real_robot_nerf_actor_tpu/ops/resnetfc_pallas.py
//   fused_resnetfc_int8        (the Pallas kernel _kernel)         -> resnetfc_int8_fwd
//   fused_gather_resnetfc_int8 (the Pallas kernel _gather_kernel)  -> gather_resnetfc_int8_fwd
//
// Per row (one ray sample) of a 64-row tile, with the rounding points of the
// TPU kernel:
//   zi     = [latent | canon | dirs | wrapped phases | 0]  (128 bf16 lanes)
//            (the gather entry point builds it in shared memory: one 64-bit
//            offset row of the corner-expanded grid per sample, lerped in
//            fp32 as r0*w0 then seven fmaf in corner order, rounded to bf16,
//            exactly as ops/lerp_cuda.corner_lerp does)
//   h      = [aux | bf16 sin(aux) | bf16 cos(aux)] . W_in + b_in       (fp32)
//            (only the aux lanes: the packed weights are zero elsewhere)
//   block i: h += zi_latent . Wz_i + bz_i             for i < combine_layer
//            t = relu(bf16(h)); a0 = dense(t, 2i); u = relu(bf16(a0))
//            h += dense(u, 2i+1)
//   hidden = bf16(relu(h)); out = bf16(hidden . W_out + b_out)  (8 of 128 cols;
//            the other 120 are zero weights and zero bias, written as 0)
// dense(x, j), int8: xs = max|x|/127 + 1e-8 per row (dynamic) or the static
//   scale act_scales[0][j] (inv = act_scales[1][j], 1/xs rounded from double
//   on the host); q = clip(rint(x * inv), -127, 127) (half to even); int32
//   accumulation on s8 x s8 mma; y = ((acc * xs) * ws[n]) + bq[n].
// dense(x, j), bf16 (quantized = 0): bf16 products, fp32 accumulation, + bq.
// Every multiply and add of the epilogues is an explicit _rn intrinsic: no
// fused multiply-add changes a rounding point.
//
// What bounds it on this card: per row 10 x 2 x 512 x 512 = 5.24 M int8
// operations and about 0.92 M bf16 flops against 256 bytes in and 1280 out:
// the tensor cores (1979 TOP/s int8, 989 TF/s bf16 on H100 SXM).
//
// Design (a simple first version): 512 threads own a 64-row tile; the fp32
// residual stream h (64 x 512, 133 KB) stays in shared memory for all five
// blocks, beside one activation buffer (int8 or bf16) and the zi rows. Each
// of the 16 warps computes a 64 x 32 column strip of every product with
// mma.sync (m16n8k32 s8 / m16n8k16 bf16); the B fragments come straight
// from the weights in device memory (2.6 MB of int8 blocks, resident in the
// 50 MB L2), packed once on the host in (out, in) layout. The activation
// buffer is rewritten between the two products of a block only after a
// barrier, from the accumulators still held in registers. No TMA, no
// wgmma, no overlap of loads and math yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // rows per block
constexpr int THREADS = 512;  // 16 warps
constexpr int NWARPS = THREADS / 32;
constexpr int WN = 32;        // output columns per warp
constexpr int MAXH = 512;     // largest d_hidden
constexpr int HLD = MAXH + 8;     // fp32 stride of h
constexpr int ALD = MAXH + 8;     // bf16 stride of the activation buffer
constexpr int QLD = MAXH + 16;    // int8 stride of the activation buffer
constexpr int ZLD = 128 + 8;      // bf16 stride of zi
constexpr size_t H_BYTES = sizeof(float) * BM * HLD;
constexpr size_t A_BYTES = sizeof(__nv_bfloat16) * BM * ALD;
constexpr size_t Z_BYTES = sizeof(__nv_bfloat16) * BM * ZLD;
constexpr size_t SMEM_BYTES = H_BYTES + A_BYTES + Z_BYTES + 3 * sizeof(float) * BM;

struct Params {
  const __nv_bfloat16* zi;   // (n, 128)            resnetfc_int8_fwd
  const void* vox;           // (cells, 8*d_latent) gather: bf16 or fp32
  const int* flat;           // (n,)
  const float* w8;           // (8, n)
  const __nv_bfloat16* aux;  // (n_aux, n)
  const __nv_bfloat16* w_in;  // (d_hidden, k_in)
  const float* b_in;          // (d_hidden)
  const __nv_bfloat16* wz;    // (ncomb, d_hidden, k_lat)
  const float* bz;            // (ncomb, d_hidden)
  const void* wq;             // (2 nb, d_hidden, d_hidden) int8 or bf16, (out, in)
  const float* ws;            // (2 nb, d_hidden)
  const float* bq;            // (2 nb, d_hidden)
  const __nv_bfloat16* w_out;  // (8, d_hidden)
  const float* b_out;          // (8)
  const float* act_scales;     // (2, 2 nb) [xs; inv] or null: dynamic
  __nv_bfloat16* out;          // (n, 128)
  __nv_bfloat16* hidden;       // (n, d_hidden)
  int n, d_latent, n_aux, d_hidden, n_blocks, combine_layer, k_in, k_lat;
  int vox_f32;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
__device__ __forceinline__ unsigned ldg32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[mt][nt][i] of a 64 x 32 strip: row mt*16 + g + 8*(i >= 2),
// column n0 + nt*8 + 2*t + (i & 1)
template <typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[4][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

// C(64 x 32 at column n0) += A(64 x K, bf16 in shared memory, stride lda
// elements) . B^T, B (N, K) bf16 in device memory
__device__ __forceinline__ void gemm_bf16(float (&acc)[4][4][4],
                                          const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int K, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* bp = B + static_cast<size_t>(n0 + nt * 8 + g) * K + k0 + 2 * t;
      b[nt][0] = ldg32(bp);
      b[nt][1] = ldg32(bp + 8);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* ap = A + (mt * 16 + g) * lda + k0 + 2 * t;
      unsigned a[4] = {lds32(ap), lds32(ap + 8 * lda), lds32(ap + 8),
                       lds32(ap + 8 * lda + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

// the same with int8 A (stride lda bytes) and int8 B (N, K)
__device__ __forceinline__ void gemm_s8(int (&acc)[4][4][4], const int8_t* A,
                                        int lda, const int8_t* B, int K, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 32) {
    unsigned b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* bp = B + static_cast<size_t>(n0 + nt * 8 + g) * K + k0 + 4 * t;
      b[nt][0] = ldg32(bp);
      b[nt][1] = ldg32(bp + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int8_t* ap = A + (mt * 16 + g) * lda + k0 + 4 * t;
      unsigned a[4] = {lds32(ap), lds32(ap + 8 * lda), lds32(ap + 16),
                       lds32(ap + 8 * lda + 16)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.f), 1e-8f);
}

__device__ __forceinline__ int8_t quantize(float x, float inv) {
  int q = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<int8_t>(min(127, max(-127, q)));
}

// one block matmul of the residual chain: acc (registers) = act . W_j, then
// the dequantized / biased fp32 values in vals
template <bool QUANT>
__device__ __forceinline__ void dense(float (&vals)[4][4][4], const Params& p,
                                      const unsigned char* abuf, int j, int n0,
                                      const float* row_xs, bool dynamic) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dh = p.d_hidden;
  const float* ws = p.ws + static_cast<size_t>(j) * dh;
  const float* bq = p.bq + static_cast<size_t>(j) * dh;
  if constexpr (QUANT) {
    int acc[4][4][4];
    zero_acc(acc);
    gemm_s8(acc, reinterpret_cast<const int8_t*>(abuf), QLD,
            static_cast<const int8_t*>(p.wq) + static_cast<size_t>(j) * dh * dh, dh, n0);
    const float xs_static = dynamic ? 0.f : p.act_scales[j];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
          const int c = n0 + nt * 8 + 2 * t + (i & 1);
          const float xs = dynamic ? row_xs[r] : xs_static;
          vals[mt][nt][i] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), xs), ws[c]), bq[c]);
        }
  } else {
    zero_acc(vals);
    gemm_bf16(vals, reinterpret_cast<const __nv_bfloat16*>(abuf), ALD,
              static_cast<const __nv_bfloat16*>(p.wq) + static_cast<size_t>(j) * dh * dh,
              dh, n0);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vals[mt][nt][i] = __fadd_rn(vals[mt][nt][i], bq[n0 + nt * 8 + 2 * t + (i & 1)]);
  }
}

// relu(bf16(h)) of every row into the activation buffer: int8 (row scale
// dynamic or static) or bf16
template <bool QUANT>
__device__ void stage_t(const Params& p, const float* hs, unsigned char* abuf,
                        float* row_xs, int* row_max, int j, bool dynamic) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dh = p.d_hidden;
  for (int r = warp; r < BM; r += NWARPS) {
    const float* hr = hs + r * HLD;
    if constexpr (QUANT) {
      float xs, inv;
      if (dynamic) {
        float amax = 0.f;
        for (int c = lane; c < dh; c += 32) amax = fmaxf(amax, fmaxf(bf16_round(hr[c]), 0.f));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        xs = quant_scale(amax);
        inv = __fdiv_rn(1.f, xs);
        if (lane == 0) {
          row_xs[r] = xs;
          row_max[r] = 0;
        }
      } else {
        xs = p.act_scales[j];
        inv = p.act_scales[2 * p.n_blocks + j];
      }
      int8_t* q = reinterpret_cast<int8_t*>(abuf) + r * QLD;
      for (int c = lane; c < dh; c += 32) q[c] = quantize(fmaxf(bf16_round(hr[c]), 0.f), inv);
    } else {
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(abuf) + r * ALD;
      for (int c = lane; c < dh; c += 32) a[c] = __float2bfloat16_rn(fmaxf(hr[c], 0.f));
    }
  }
}

template <bool QUANT, bool GATHER>
__global__ void __launch_bounds__(THREADS, 1) resnetfc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  unsigned char* abuf = smem + H_BYTES;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem + H_BYTES + A_BYTES);
  float* row_xs = reinterpret_cast<float*>(smem + H_BYTES + A_BYTES + Z_BYTES);
  float* row_inv = row_xs + BM;
  int* row_max = reinterpret_cast<int*>(row_inv + BM);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int n = p.n, dh = p.d_hidden, dl = p.d_latent;
  const bool dynamic = QUANT && p.act_scales == nullptr;
  const int n0 = warp * WN;
  const bool active = n0 < dh;

  // ---- zi rows of this tile (zero past the last row)
  if constexpr (!GATHER) {
    for (int i = tid; i < BM * 16; i += THREADS) {
      const int r = i >> 4, v = i & 15;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n)
        val = reinterpret_cast<const uint4*>(p.zi + (row0 + r) * 128)[v];
      *reinterpret_cast<uint4*>(zs + r * ZLD + v * 8) = val;
    }
  } else {
    const int width = dl + p.n_aux;
    for (int i = tid; i < BM * (128 - dl); i += THREADS) {
      const int r = i / (128 - dl), c = dl + i % (128 - dl);
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (row0 + r < n && c < width) v = p.aux[static_cast<long long>(c - dl) * n + row0 + r];
      zs[r * ZLD + c] = v;
    }
    const int c8 = 8 * dl;
    for (int i = tid; i < BM * dl; i += THREADS) {
      const int r = i / dl, c = i % dl;
      float acc = 0.f;
      const long long row = row0 + r;
      if (row < n) {
        // 64-bit byte offset: the expanded 101^3 x 512 bf16 grid is 1.05 GB
        const long long base = static_cast<long long>(p.flat[row]) * c8 + c;
        const float* w8 = p.w8 + row;
        if (p.vox_f32) {
          const float* vx = static_cast<const float*>(p.vox) + base;
          acc = __fmul_rn(vx[0], w8[0]);
#pragma unroll
          for (int k = 1; k < 8; ++k) acc = __fmaf_rn(vx[k * dl], w8[static_cast<long long>(k) * n], acc);
        } else {
          const __nv_bfloat16* vx = static_cast<const __nv_bfloat16*>(p.vox) + base;
          acc = __fmul_rn(__bfloat162float(vx[0]), w8[0]);
#pragma unroll
          for (int k = 1; k < 8; ++k)
            acc = __fmaf_rn(__bfloat162float(vx[k * dl]), w8[static_cast<long long>(k) * n], acc);
        }
      }
      zs[r * ZLD + c] = __float2bfloat16_rn(acc);
    }
  }
  __syncthreads();

  // ---- first layer on the aux lanes: [aux | sin | cos | 0] . W_in + b_in
  {
    const int lin = p.k_in + 8;
    __nv_bfloat16* ain = reinterpret_cast<__nv_bfloat16*>(abuf);
    const int na = p.n_aux;
    for (int i = tid; i < BM * p.k_in; i += THREADS) {
      const int r = i / p.k_in, j = i % p.k_in;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (j < na) {
        v = zs[r * ZLD + dl + j];
      } else if (j < 3 * na) {
        const float x = __bfloat162float(zs[r * ZLD + dl + (j < 2 * na ? j - na : j - 2 * na)]);
        v = __float2bfloat16_rn(j < 2 * na ? sinf(x) : cosf(x));
      }
      ain[r * lin + j] = v;
    }
    __syncthreads();
    if (active) {
      float acc[4][4][4];
      zero_acc(acc);
      gemm_bf16(acc, ain, lin, p.w_in, p.k_in, n0);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
            const int c = n0 + nt * 8 + 2 * t + (i & 1);
            hs[r * HLD + c] = __fadd_rn(acc[mt][nt][i], p.b_in[c]);
          }
    }
    __syncthreads();
  }

  for (int blk = 0; blk < p.n_blocks; ++blk) {
    // ---- latent injection: h = h + (lat . Wz + bz)
    if (blk < p.combine_layer) {
      if (active) {
        float acc[4][4][4];
        zero_acc(acc);
        gemm_bf16(acc, zs, ZLD, p.wz + static_cast<size_t>(blk) * dh * p.k_lat, p.k_lat, n0);
        const float* bz = p.bz + static_cast<size_t>(blk) * dh;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
              const int c = n0 + nt * 8 + 2 * t + (i & 1);
              hs[r * HLD + c] = __fadd_rn(hs[r * HLD + c], __fadd_rn(acc[mt][nt][i], bz[c]));
            }
      }
      __syncthreads();
    }

    // ---- t = relu(bf16(h)) -> a0 = dense(t) -> u = relu(bf16(a0))
    stage_t<QUANT>(p, hs, abuf, row_xs, row_max, 2 * blk, dynamic);
    __syncthreads();
    float vals[4][4][4];
    if (active) {
      dense<QUANT>(vals, p, abuf, 2 * blk, n0, row_xs, dynamic);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) vals[mt][nt][i] = fmaxf(bf16_round(vals[mt][nt][i]), 0.f);
      if (dynamic) {  // row max of u over this warp's columns
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float m = 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              m = fmaxf(m, fmaxf(vals[mt][nt][2 * half], vals[mt][nt][2 * half + 1]));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            if (t == 0) atomicMax(row_max + mt * 16 + g + 8 * half, __float_as_int(m));
          }
      }
    }
    __syncthreads();  // every warp is done reading t (and its row scales)
    if constexpr (QUANT) {
      if (tid < BM) {
        const float xs = dynamic ? quant_scale(__int_as_float(row_max[tid])) : 0.f;
        row_xs[tid] = xs;
        row_inv[tid] = dynamic ? __fdiv_rn(1.f, xs) : 0.f;
      }
      __syncthreads();
    }
    if (active) {
      const float inv_static = (QUANT && !dynamic) ? p.act_scales[2 * p.n_blocks + 2 * blk + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
            const int c = n0 + nt * 8 + 2 * t + (i & 1);
            if constexpr (QUANT) {
              const float inv = dynamic ? row_inv[r] : inv_static;
              reinterpret_cast<int8_t*>(abuf)[r * QLD + c] = quantize(vals[mt][nt][i], inv);
            } else {
              reinterpret_cast<__nv_bfloat16*>(abuf)[r * ALD + c] =
                  __float2bfloat16_rn(vals[mt][nt][i]);
            }
          }
    }
    __syncthreads();

    // ---- h += dense(u)
    if (active) {
      dense<QUANT>(vals, p, abuf, 2 * blk + 1, n0, row_xs, dynamic);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
            const int c = n0 + nt * 8 + 2 * t + (i & 1);
            hs[r * HLD + c] = __fadd_rn(hs[r * HLD + c], vals[mt][nt][i]);
          }
    }
    __syncthreads();
  }

  // ---- hidden = bf16(relu(h)): to shared memory (head operand) and out
  __nv_bfloat16* hid = reinterpret_cast<__nv_bfloat16*>(abuf);
  for (int i = tid; i < BM * dh; i += THREADS) {
    const int r = i / dh, c = i % dh;
    hid[r * ALD + c] = __float2bfloat16_rn(fmaxf(hs[r * HLD + c], 0.f));
  }
  __syncthreads();
  const int vpr = dh / 8;  // 16-byte vectors per hidden row
  for (int i = tid; i < BM * vpr; i += THREADS) {
    const int r = i / vpr, v = i % vpr;
    if (row0 + r < n)
      reinterpret_cast<uint4*>(p.hidden + (row0 + r) * dh)[v] =
          *reinterpret_cast<const uint4*>(hid + r * ALD + v * 8);
  }

  // ---- head: out[:, 0:8] = bf16(hidden . W_out^T + b_out); out[:, 8:128] = 0
  if (warp < 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < dh; k0 += 16) {
      const __nv_bfloat16* bp = p.w_out + static_cast<size_t>(g) * dh + k0 + 2 * t;
      const __nv_bfloat16* ap = hid + (warp * 16 + g) * ALD + k0 + 2 * t;
      unsigned a[4] = {lds32(ap), lds32(ap + 8 * ALD), lds32(ap + 8), lds32(ap + 8 * ALD + 8)};
      mma_bf16(acc, a, ldg32(bp), ldg32(bp + 8));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = row0 + warp * 16 + g + 8 * half;
      if (row < n) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(__fadd_rn(acc[2 * half], p.b_out[2 * t]));
        v.y = __float2bfloat16_rn(__fadd_rn(acc[2 * half + 1], p.b_out[2 * t + 1]));
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * 128 + 2 * t) = v;
      }
    }
  }
  for (int i = tid; i < BM * 15; i += THREADS) {
    const int r = i / 15, v = i % 15;
    if (row0 + r < n)
      reinterpret_cast<uint4*>(p.out + (row0 + r) * 128 + 8)[v] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <bool QUANT, bool GATHER>
int launch(const Params& p, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(resnetfc_kernel<QUANT, GATHER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (p.n == 0) return 0;
  const unsigned grid = static_cast<unsigned>((p.n + BM - 1) / BM);
  resnetfc_kernel<QUANT, GATHER><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(const Params& p) {
  return p.d_hidden > 0 && p.d_hidden <= MAXH && p.d_hidden % WN == 0 &&
         p.k_in % 16 == 0 && p.k_in >= 3 * p.n_aux && p.k_in <= MAXH &&
         p.k_lat % 16 == 0 && p.k_lat >= p.d_latent && p.d_latent + p.n_aux <= 128 &&
         p.k_lat <= 128;
}

int dispatch(Params& p, int quantized, bool gather, void* stream) {
  if (!shapes_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (gather) return quantized ? launch<true, true>(p, s) : launch<false, true>(p, s);
  return quantized ? launch<true, false>(p, s) : launch<false, false>(p, s);
}

}  // namespace

// Weights as packed by ops/resnetfc_cuda.pack_resnetfc_params (its "kernel"
// entry), all contiguous; act_scales (2, 2*n_blocks) fp32 [xs; inv] or null
// for dynamic per-row scales. Returns the launch's cudaError_t.
extern "C" int resnetfc_int8_fwd(
    const void* zi, const void* w_in, const void* b_in, const void* wz,
    const void* bz, const void* wq, const void* ws, const void* bq,
    const void* w_out, const void* b_out, const void* act_scales, void* out,
    void* hidden, int n, int d_latent, int n_aux, int d_hidden, int n_blocks,
    int combine_layer, int k_in, int k_lat, int quantized, void* stream) {
  Params p{};
  p.zi = static_cast<const __nv_bfloat16*>(zi);
  p.w_in = static_cast<const __nv_bfloat16*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.wz = static_cast<const __nv_bfloat16*>(wz);
  p.bz = static_cast<const float*>(bz);
  p.wq = wq;
  p.ws = static_cast<const float*>(ws);
  p.bq = static_cast<const float*>(bq);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.act_scales = static_cast<const float*>(act_scales);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hidden = static_cast<__nv_bfloat16*>(hidden);
  p.n = n; p.d_latent = d_latent; p.n_aux = n_aux; p.d_hidden = d_hidden;
  p.n_blocks = n_blocks; p.combine_layer = combine_layer; p.k_in = k_in; p.k_lat = k_lat;
  return dispatch(p, quantized, false, stream);
}

// vox (cells, 8*d_latent) bf16 (vox_f32 = 0) or fp32 rows of the
// corner-expanded grid; flat (n,) int32; w8 (8, n) fp32; aux (n_aux, n) bf16.
extern "C" int gather_resnetfc_int8_fwd(
    const void* vox, const void* flat, const void* w8, const void* aux,
    const void* w_in, const void* b_in, const void* wz, const void* bz,
    const void* wq, const void* ws, const void* bq, const void* w_out,
    const void* b_out, const void* act_scales, void* out, void* hidden, int n,
    int d_latent, int n_aux, int d_hidden, int n_blocks, int combine_layer,
    int k_in, int k_lat, int quantized, int vox_f32, void* stream) {
  Params p{};
  p.vox = vox;
  p.flat = static_cast<const int*>(flat);
  p.w8 = static_cast<const float*>(w8);
  p.aux = static_cast<const __nv_bfloat16*>(aux);
  p.w_in = static_cast<const __nv_bfloat16*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.wz = static_cast<const __nv_bfloat16*>(wz);
  p.bz = static_cast<const float*>(bz);
  p.wq = wq;
  p.ws = static_cast<const float*>(ws);
  p.bq = static_cast<const float*>(bq);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.act_scales = static_cast<const float*>(act_scales);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hidden = static_cast<__nv_bfloat16*>(hidden);
  p.n = n; p.d_latent = d_latent; p.n_aux = n_aux; p.d_hidden = d_hidden;
  p.n_blocks = n_blocks; p.combine_layer = combine_layer; p.k_in = k_in; p.k_lat = k_lat;
  p.vox_f32 = vox_f32;
  return dispatch(p, quantized, true, stream);
}

EXPORT_ERROR_STRING
