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
//   accumulation on s8 x s8 products; y = ((acc * xs) * ws[n]) + bq[n].
// dense(x, j), bf16 (quantized = 0): bf16 products, fp32 accumulation, + bq.
// Every multiply and add of the epilogues is an explicit _rn intrinsic: no
// fused multiply-add changes a rounding point.
//
// What bounds it on this card: per row 10 x 2 x 512 x 512 = 5.24 M int8
// operations and 0.29 M bf16 flops against 256 bytes in and 1280 out: the
// tensor cores (1979 TOP/s int8 on H100 SXM), 0.174 ms for 65536 rows. But
// a tile's fp32 residual stream (64 x 512 x 4 = 128 KB) must stay in shared
// memory, so a block holds 64 rows (128 would need 256 KB, over the 227 KB a
// block can have), and every 64-row tile reads all ten 512 x 512 int8 block
// matrices: 2.62 MB of weights from L2 per tile, 2.68 GB for 65536 rows.
// That weight stream, not the int8 rate, is what this kernel has to feed.
//
// Two designs, one set of rounding points (int32 sums are exact in any
// order, and the bf16 parts are the same mma.sync code in both):
//
// resnetfc_wgmma (quantized, d_hidden 256 or 512, k_in <= 112, k_lat <= 64:
// the serving configs): one block of two warpgroups per 64-row tile. The ten
// int8 block matrices stream, in order and without a break between them,
// through a 3-stage ring of (d_hidden x 32) int8 slices (16 KB, 32-byte
// swizzle: the 48 KB that shared memory leaves beside h hold three such
// slices, so a slice carries 32 of K for every output column). Each slice
// is one TMA bulk copy of 16 contiguous KB: the host keeps a copy of the
// weights laid out slice by slice, already swizzled
// (ops/resnetfc_cuda.ring_layout). A tiled TMA box of the (out, in)
// matrices would move a slice as 512 rows of 32 bytes, and one SM takes in
// such boxes at 31.7 B a cycle, against 52 for one bulk copy (the ring
// probe of tools/mlp_phases.py). Thread 0 issues the loads: the first three
// at the start, then each slice's successor once all 8 warps have freed it,
// so the next matrix's first slices load while an epilogue runs. (No
// producer warp: registers are handed out by warpgroups, so a ninth warp
// caps every thread at 168 and the 128-register accumulator spills;
// setmaxnreg cannot pass on more than that lone warp gives back.) The
// activation (t or u, 64 x 512 int8) sits in
// shared memory in the 128-byte-swizzled K-major layout that a wgmma
// descriptor reads; each product is wgmma m64n256k32 s32.s8.s8 (n128 for
// d_hidden 256), A and B from descriptors, warpgroup w owning output columns
// [w H/2, (w+1) H/2), one product in flight while the next is issued. The
// epilogues write the int8 codes straight into that layout, then
// fence.proxy.async and a barrier before the next product reads them. ws and
// bq of the matrix in use are copied into shared memory (cp.async) while its
// products run. h (64 x 512 fp32, rows padded by 8 floats so the accumulator
// fragments' stores do not conflict) stays in shared memory; the dynamic row
// scale of u is a shared-memory atomic max over both warpgroups. The first
// layer, the injections and the head keep the mma.sync code below (their B
// fragments and biases loaded before the products; the latent lanes in their
// own 9 KB buffer, the aux lanes in the activation buffer until the first
// product). Shared memory: ring 48 KB + activation 32 KB + h 130 KB + latent
// 9 KB + scales 4 KB. What bounds it (tools/mlp_phases.py, PERF.md): the
// products, one wgmma of K 32 per warpgroup and slice, take about twice as
// long as the 2.62 MB of weight copies per tile alone, and the CUDA-core
// work between them (epilogues, t, the bf16 mma.sync parts) runs in series
// with them.
//
// resnetfc_kernel (every other call, the bf16 one included; the first
// version): 512 threads own a 64-row tile beside the same h; each of the 16
// warps computes a 64 x 32 column strip of every product with mma.sync
// (m16n8k32 s8 / m16n8k16 bf16), the B fragments read straight from the
// weights in L2 with 4-byte loads; six block-wide barriers a block, no
// overlap of loads and math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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
  const void* wq;             // (2 nb, d_hidden, d_hidden) int8 or bf16, (out, in);
                              // resnetfc_wgmma: int8 in ring_layout
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

// the same with every B fragment loaded before the first product (K a
// multiple of 16, at most KMAX): one L2 round trip instead of K / 16 of them,
// the same products in the same order
template <int KMAX>
__device__ __forceinline__ void gemm_bf16_prefetch(float (&acc)[4][4][4],
                                                   const __nv_bfloat16* A, int lda,
                                                   const __nv_bfloat16* B, int K, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned b[KMAX / 16][4][2];
#pragma unroll
  for (int kk = 0; kk < KMAX / 16; ++kk) {
    if (16 * kk < K) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* bp = B + static_cast<size_t>(n0 + nt * 8 + g) * K + 16 * kk + 2 * t;
        b[kk][nt][0] = ldg32(bp);
        b[kk][nt][1] = ldg32(bp + 8);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < KMAX / 16; ++kk) {
    if (16 * kk >= K) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* ap = A + (mt * 16 + g) * lda + 16 * kk + 2 * t;
      unsigned a[4] = {lds32(ap), lds32(ap + 8 * lda), lds32(ap + 8),
                       lds32(ap + 8 * lda + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[kk][nt][0], b[kk][nt][1]);
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

// ---- the parts both designs share: the tile's zi rows, the first layer and
// the latent injections (bf16 on mma.sync, fp32 sums in one order)

// zi rows of the tile starting at row0 (zero past the last row) into zs,
// stride ZLD; nthreads threads, this one tid
template <bool GATHER>
__device__ __forceinline__ void load_zi(const Params& p, __nv_bfloat16* zs, long long row0,
                                        int tid, int nthreads) {
  const int n = p.n, dl = p.d_latent;
  if constexpr (!GATHER) {
    for (int i = tid; i < BM * 16; i += nthreads) {
      const int r = i >> 4, v = i & 15;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n)
        val = reinterpret_cast<const uint4*>(p.zi + (row0 + r) * 128)[v];
      *reinterpret_cast<uint4*>(zs + r * ZLD + v * 8) = val;
    }
  } else {
    const int width = dl + p.n_aux;
    for (int i = tid; i < BM * (128 - dl); i += nthreads) {
      const int r = i / (128 - dl), c = dl + i % (128 - dl);
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (row0 + r < n && c < width) v = p.aux[static_cast<long long>(c - dl) * n + row0 + r];
      zs[r * ZLD + c] = v;
    }
    const int c8 = 8 * dl;
    for (int i = tid; i < BM * dl; i += nthreads) {
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
}

// the first layer's input [aux | sin | cos | 0] (BM x k_in, stride k_in + 8),
// one aux value and its sine and cosine per step
__device__ __forceinline__ void build_ain(const Params& p, const __nv_bfloat16* zs,
                                          __nv_bfloat16* ain, int tid, int nthreads) {
  const int lin = p.k_in + 8, na = p.n_aux, dl = p.d_latent, pad = p.k_in - 3 * na;
  for (int i = tid; i < BM * na; i += nthreads) {
    const int r = i / na, j = i - r * na;
    const __nv_bfloat16 v = zs[r * ZLD + dl + j];
    const float x = __bfloat162float(v);
    __nv_bfloat16* a = ain + r * lin;
    a[j] = v;
    a[na + j] = __float2bfloat16_rn(sinf(x));
    a[2 * na + j] = __float2bfloat16_rn(cosf(x));
  }
  for (int i = tid; i < BM * pad; i += nthreads) {
    const int r = i / pad;
    ain[r * lin + 3 * na + i - r * pad] = __float2bfloat16_rn(0.f);
  }
}

// B (N, K) . A for the bf16 parts: the first version's loop (KMAX 0) or every
// B fragment loaded first (K <= KMAX)
template <int KMAX>
__device__ __forceinline__ void gemm_bf16_any(float (&acc)[4][4][4], const __nv_bfloat16* A,
                                              int lda, const __nv_bfloat16* B, int K, int n0) {
  if constexpr (KMAX == 0) gemm_bf16(acc, A, lda, B, K, n0);
  else gemm_bf16_prefetch<KMAX>(acc, A, lda, B, K, n0);
}

// the 8 bias values of a 64 x 32 strip's columns that this lane holds,
// loaded before the product so their latency overlaps it (KMAX != 0; the
// first version reads them where it adds them)
__device__ __forceinline__ void load_bias(float (&bias)[4][2], const float* b, int n0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bias[nt][0] = b[n0 + nt * 8 + 2 * t];
    bias[nt][1] = b[n0 + nt * 8 + 2 * t + 1];
  }
}

// h[:, n0:n0+32] = ain . W_in^T + b_in
template <int KMAX = 0>
__device__ __forceinline__ void first_layer(const Params& p, const __nv_bfloat16* ain,
                                            float* hs, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][4][4], bias[4][2];
  if constexpr (KMAX != 0) load_bias(bias, p.b_in, n0);
  zero_acc(acc);
  gemm_bf16_any<KMAX>(acc, ain, p.k_in + 8, p.w_in, p.k_in, n0);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
        const int c = n0 + nt * 8 + 2 * t + (i & 1);
        hs[r * HLD + c] = __fadd_rn(acc[mt][nt][i], KMAX ? bias[nt][i & 1] : p.b_in[c]);
      }
}

// h[:, n0:n0+32] = h + (lat . Wz_blk^T + bz_blk), lat bf16 with stride ld
template <int KMAX = 0>
__device__ __forceinline__ void inject(const Params& p, const __nv_bfloat16* lat, int ld,
                                       float* hs, int blk, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dh = p.d_hidden;
  const float* bz = p.bz + static_cast<size_t>(blk) * dh;
  float acc[4][4][4], bias[4][2];
  if constexpr (KMAX != 0) load_bias(bias, bz, n0);
  zero_acc(acc);
  gemm_bf16_any<KMAX>(acc, lat, ld, p.wz + static_cast<size_t>(blk) * dh * p.k_lat, p.k_lat,
                      n0);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
        const int c = n0 + nt * 8 + 2 * t + (i & 1);
        hs[r * HLD + c] =
            __fadd_rn(hs[r * HLD + c], __fadd_rn(acc[mt][nt][i], KMAX ? bias[nt][i & 1] : bz[c]));
      }
}

// ================================================ the first version (mma.sync)

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
  const int n = p.n, dh = p.d_hidden;
  const bool dynamic = QUANT && p.act_scales == nullptr;
  const int n0 = warp * WN;
  const bool active = n0 < dh;

  load_zi<GATHER>(p, zs, row0, tid, THREADS);
  __syncthreads();

  // ---- first layer on the aux lanes: [aux | sin | cos | 0] . W_in + b_in
  __nv_bfloat16* ain = reinterpret_cast<__nv_bfloat16*>(abuf);
  build_ain(p, zs, ain, tid, THREADS);
  __syncthreads();
  if (active) first_layer(p, ain, hs, n0);
  __syncthreads();

  for (int blk = 0; blk < p.n_blocks; ++blk) {
    // ---- latent injection: h = h + (lat . Wz + bz)
    if (blk < p.combine_layer) {
      if (active) inject(p, zs, ZLD, hs, blk, n0);
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

// ========================================== wgmma + TMA weight ring (int8)
namespace wg {

constexpr int THREADS = 256;              // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;
constexpr int KS = 32;                    // int8 K of one wgmma and one stage
constexpr int STAGE_BYTES = MAXH * KS;    // every output column, 32 of K: 16 KB
constexpr int ACT_BYTES = BM * MAXH;      // t or u, int8, 128-byte swizzle
constexpr int ACT_CHUNK = BM * 128;       // 128 of K: 8 KB
constexpr int ZL = 72;                    // bf16 stride of the latent lanes
constexpr int MAX_KIN = 112;              // the aux input fits the activation buffer
constexpr int MAX_KLAT = 64;              // the latent lanes fit theirs
constexpr int OFF_ACT = STAGES * STAGE_BYTES;
constexpr int OFF_H = OFF_ACT + ACT_BYTES;
constexpr int OFF_Z = OFF_H + static_cast<int>(H_BYTES);
constexpr int OFF_SC = OFF_Z + BM * ZL * 2;  // ws and bq of the matrix in use
constexpr int OFF_ROW = OFF_SC + 2 * MAXH * 4;
constexpr int OFF_BAR = OFF_ROW + 3 * BM * 4;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "over the 227 KB of shared memory a block can have");
static_assert(static_cast<int>(Z_BYTES) + BM * (MAX_KIN + 8) * 2 <= ACT_BYTES,
              "zi and the first layer's input live in the activation buffer");

// byte of activation (r, c): 128-column chunks of K of 64 rows x 128 bytes,
// the 16-byte groups of row r XOR-ed with r % 8 (what a 128-byte-swizzle
// K-major wgmma descriptor reads)
__device__ __forceinline__ int act_off(int r, int c) {
  return (c >> 7) * ACT_CHUNK + r * 128 + ((((c >> 4) & 7) ^ (r & 7)) << 4) + (c & 15);
}

// t = relu(bf16(h)) of every row as int8 codes into the activation buffer;
// the dynamic row scale into row_xs (and row_max reset for u's)
template <int DH>
__device__ __forceinline__ void stage_t_s8(const Params& p, const float* hs, unsigned char* act,
                                           float* row_xs, int* row_max, int j, bool dynamic) {
  constexpr int V = DH / 128;  // 4-column groups of a row per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += WARPS) {
    const float* hr = hs + r * HLD;
    float x[V][4];
    float amax = 0.f;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(hr + 128 * q + 4 * lane);
      x[q][0] = fmaxf(bf16_round(f.x), 0.f);
      x[q][1] = fmaxf(bf16_round(f.y), 0.f);
      x[q][2] = fmaxf(bf16_round(f.z), 0.f);
      x[q][3] = fmaxf(bf16_round(f.w), 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, x[q][e]);
    }
    float inv;
    if (dynamic) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float xs = quant_scale(amax);
      inv = __fdiv_rn(1.f, xs);
      if (lane == 0) {
        row_xs[r] = xs;
        row_max[r] = 0;
      }
    } else {
      inv = p.act_scales[2 * p.n_blocks + j];
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(x[q][e], inv))) << (8 * e);
      *reinterpret_cast<uint32_t*>(act + act_off(r, 128 * q + 4 * lane)) = w;
    }
  }
}

// The weight ring: STAGES slices of (DH x 32) int8 in shared memory, slice r
// of the stream being K step r % KSTEPS of block matrix r / KSTEPS, which
// ring_layout stores as the r-th DH x 32 contiguous bytes of `src`; `full`
// barriers that its bulk copies complete, `empty` ones that the 8 warps
// arrive on when done with a slice. Thread 0 issues every load: the first STAGES
// at the start, then each slice's successor once every warp has freed it,
// so the next matrix's first slices load during an epilogue.
template <int DH>
struct Ring {
  const unsigned char* src;
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  int total;  // slices of all the block matrices

  __device__ __forceinline__ void load(int r) const {
    const int s = r % STAGES;
    hopper::mbar_expect_tx(&full[s], DH * KS);
    hopper::bulk_load(buf + s * STAGE_BYTES, src + static_cast<size_t>(r) * DH * KS, DH * KS,
                      &full[s]);
  }
  __device__ __forceinline__ const unsigned char* wait_full(int r) const {
    hopper::mbar_wait(&full[r % STAGES], (r / STAGES) & 1);
    return buf + (r % STAGES) * STAGE_BYTES;
  }
  // this warp is done with slice r
  __device__ __forceinline__ void release(int r) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[r % STAGES]);
    if (threadIdx.x == 0 && r + STAGES < total) {
      hopper::mbar_wait(&empty[r % STAGES], (r / STAGES) & 1);
      load(r + STAGES);
    }
  }
};

// acc = act . W_j^T for this warpgroup's HN output columns: the matrix's
// 2 HN / 32 ring slices in order, from slice `it` on, each freed as soon as
// its product ends. (The copies keep up: on an H100 the loop takes as long
// when each slice is freed one step later, and about twice as long as the
// copies alone; tools/mlp_phases.py, PERF.md.) Meanwhile the threads copy
// ws_j and bq_j (16 bytes each) into `sc`, which holds them for the
// epilogue once every thread has passed the next barrier.
template <int HN>
__device__ __forceinline__ void block_product(int (&acc)[HN / 2], const unsigned char* act,
                                              const Ring<2 * HN>& ring, int& it,
                                              const Params& p, int j, float* sc) {
  constexpr int KSTEPS = 2 * HN / KS;
  constexpr int CHUNKS = 2 * HN / 4;  // 16-byte pieces of ws_j (and of bq_j)
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  if (tid < 2 * CHUNKS) {
    const float* src = (tid < CHUNKS ? p.ws : p.bq) + static_cast<size_t>(j) * 2 * HN;
    hopper::cp_async16(sc + (tid < CHUNKS ? 0 : MAXH) + 4 * (tid % CHUNKS),
                       src + 4 * (tid % CHUNKS));
  }
  // the first wgmma overwrites acc, but its asm reads it: zeros here end the
  // previous product's live range (it would otherwise spill beside the
  // epilogue's values)
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) acc[i] = 0;
#pragma unroll 1
  for (int k = 0; k < KSTEPS; ++k, ++it) {
    const unsigned char* slice = ring.wait_full(it);
    const uint64_t da = hopper::desc_sw128(act + (k >> 2) * ACT_CHUNK) + 2 * (k & 3);
    const uint64_t db = hopper::desc_sw32(slice + wgi * HN * KS);
    hopper::wgmma_fence();
    hopper::wgmma_s8_ss<HN>(acc, da, db, k);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    ring.release(it);
  }
  hopper::fence_regs(acc);
  hopper::cp_async_wait_all();
}

// HN = d_hidden / 4, the output columns of one warpgroup
template <bool GATHER, int HN>
__global__ void __launch_bounds__(THREADS, 1)
resnetfc_wgmma(const Params p) {
  constexpr int DH = 2 * HN;
  constexpr int KSTEPS = DH / KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* act = smem + OFF_ACT;
  float* hs = reinterpret_cast<float*>(smem + OFF_H);
  __nv_bfloat16* zl = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Z);
  float* sc = reinterpret_cast<float*>(smem + OFF_SC);
  float* row_xs = reinterpret_cast<float*>(smem + OFF_ROW);
  float* row_inv = row_xs + BM;
  int* row_max = reinterpret_cast<int*>(row_inv + BM);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  const Ring<DH> ring{static_cast<const unsigned char*>(p.wq), smem, full, full + STAGES,
                      2 * p.n_blocks * KSTEPS};

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], WARPS);
    }
    hopper::mbar_fence_init();
    for (int r = 0; r < STAGES && r < ring.total; ++r) ring.load(r);
  }
  __syncthreads();

  // warpgroup wgi owns output columns [wgi HN, (wgi + 1) HN) of each product
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wgi = tid >> 7;
  const int r0 = 16 * (warp & 3) + g;  // accumulator rows r0, r0 + 8
  const int cb = wgi * HN + 2 * t;     // accumulator columns cb + 8 j + {0, 1}
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int n = p.n;
  const bool dynamic = p.act_scales == nullptr;

  // ---- zi rows (in the activation buffer until the first product), the
  // latent lanes kept for the injections, the first layer's input
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(act);
  __nv_bfloat16* ain = zs + BM * ZLD;
  load_zi<GATHER>(p, zs, row0, tid, THREADS);
  __syncthreads();
  const int lv = p.k_lat / 8;  // 16-byte vectors of a row's latent lanes
  for (int i = tid; i < BM * lv; i += THREADS) {
    const int r = i / lv, c = 8 * (i - r * lv);
    *reinterpret_cast<uint4*>(zl + r * ZL + c) = *reinterpret_cast<const uint4*>(zs + r * ZLD + c);
  }
  build_ain(p, zs, ain, tid, THREADS);
  __syncthreads();
  // the bf16 parts: warp w owns columns [w DH / 8, (w + 1) DH / 8)
  const int wc = warp * (DH / 8);
#pragma unroll
  for (int c = 0; c < DH / 8; c += WN) first_layer<MAX_KIN>(p, ain, hs, wc + c);
  __syncthreads();

  int it = 0;  // ring position
  int acc[HN / 2];  // a product's int32 sums
  for (int blk = 0; blk < p.n_blocks; ++blk) {
    if (blk < p.combine_layer) {
#pragma unroll
      for (int c = 0; c < DH / 8; c += WN) inject<MAX_KLAT>(p, zl, ZL, hs, blk, wc + c);
      __syncthreads();
    }

    // The epilogues' addresses: constant offsets from three bases, which are
    // made anew in every block (the opaque copy of r0): hoisted out of the
    // block loop, the 64 addresses of each epilogue would stay live and spill.
    int rb = r0;
    asm volatile("" : "+r"(rb));
    float* hrow = hs + rb * HLD + cb;          // h (r0, cb); row r0 + 8 at + 8 HLD
    const float* wrow = sc + cb;               // ws (cb); bq at + MAXH
    // u's code of (r0 + 8 h2, cb + 8 jj) is at arow + (jj / 16) 8 KB + 1 KB h2
    // + 8 (jj % 2) + the 16-byte group (jj / 2) % 8 XOR-ed with the row's r % 8
    unsigned char* arow = act + (wgi * HN / 128) * ACT_CHUNK + rb * 128 + 2 * t;
    const int rx = rb & 7;

    // ---- t = relu(bf16(h)) -> a0 = dense(t) -> u = relu(bf16(a0))
    stage_t_s8<DH>(p, hs, act, row_xs, row_max, 2 * blk, dynamic);
    hopper::fence_proxy_async();
    __syncthreads();
    block_product<HN>(acc, act, ring, it, p, 2 * blk, sc);
    __syncthreads();  // ws and bq in sc
    {
      const int j = 2 * blk;
      const float xs0 = dynamic ? row_xs[r0] : p.act_scales[j];
      const float xs1 = dynamic ? row_xs[r0 + 8] : xs0;
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < HN / 8; ++jj) {
        const float2 w2 = *reinterpret_cast<const float2*>(wrow + 8 * jj);
        const float2 b2 = *reinterpret_cast<const float2*>(wrow + MAXH + 8 * jj);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * jj + 2 * h2;
          const float xs = h2 ? xs1 : xs0;
          const float u0 = fmaxf(bf16_round(__fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), xs), w2.x), b2.x)), 0.f);
          const float u1 = fmaxf(bf16_round(__fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i + 1]), xs), w2.y), b2.y)), 0.f);
          acc[i] = __float_as_int(u0);  // u kept as float bits until quantized
          acc[i + 1] = __float_as_int(u1);
          const float m = fmaxf(u0, u1);
          if (h2) m1 = fmaxf(m1, m);
          else m0 = fmaxf(m0, m);
        }
      }
      if (dynamic) {  // row max of u over this thread's columns, then the quad's
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        if (t == 0) {
          atomicMax(row_max + r0, __float_as_int(m0));
          atomicMax(row_max + r0 + 8, __float_as_int(m1));
        }
      }
    }
    __syncthreads();  // both warpgroups are done reading t (and its row scales)
    if (dynamic) {
      if (tid < BM) {
        const float xs = quant_scale(__int_as_float(row_max[tid]));
        row_xs[tid] = xs;
        row_inv[tid] = __fdiv_rn(1.f, xs);
      }
      __syncthreads();
    }
    {
      const float inv_static = dynamic ? 0.f : p.act_scales[2 * p.n_blocks + 2 * blk + 1];
      const float inv0 = dynamic ? row_inv[r0] : inv_static;
      const float inv1 = dynamic ? row_inv[r0 + 8] : inv_static;
#pragma unroll
      for (int jj = 0; jj < HN / 8; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * jj + 2 * h2;
          const float inv = h2 ? inv1 : inv0;
          const uint16_t pair =
              static_cast<uint16_t>(static_cast<uint8_t>(quantize(__int_as_float(acc[i]), inv))) |
              static_cast<uint16_t>(static_cast<uint8_t>(quantize(__int_as_float(acc[i + 1]), inv)))
                  << 8;
          *reinterpret_cast<uint16_t*>(arow + (jj >> 4) * ACT_CHUNK + 1024 * h2 + 8 * (jj & 1) +
                                       ((((jj >> 1) & 7) ^ rx) << 4)) = pair;
        }
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // ---- h += dense(u)
    block_product<HN>(acc, act, ring, it, p, 2 * blk + 1, sc);
    __syncthreads();
    {
      const int j = 2 * blk + 1;
      const float xs0 = dynamic ? row_xs[r0] : p.act_scales[j];
      const float xs1 = dynamic ? row_xs[r0 + 8] : xs0;
#pragma unroll
      for (int jj = 0; jj < HN / 8; ++jj) {
        const float2 w2 = *reinterpret_cast<const float2*>(wrow + 8 * jj);
        const float2 b2 = *reinterpret_cast<const float2*>(wrow + MAXH + 8 * jj);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * jj + 2 * h2;
          const float xs = h2 ? xs1 : xs0;
          float2* hp = reinterpret_cast<float2*>(hrow + 8 * h2 * HLD + 8 * jj);
          float2 hv = *hp;
          hv.x = __fadd_rn(hv.x, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i]), xs),
                                                     w2.x), b2.x));
          hv.y = __fadd_rn(hv.y, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i + 1]),
                                                               xs), w2.y), b2.y));
          *hp = hv;
        }
      }
    }
    __syncthreads();
  }

  // ---- hidden = bf16(relu(h)) to device memory
  constexpr int VPR = DH / 8;  // 16-byte vectors per hidden row
  for (int i = tid; i < BM * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (row0 + r < n) {
      const float4 a = *reinterpret_cast<const float4*>(hs + r * HLD + c);
      const float4 b = *reinterpret_cast<const float4*>(hs + r * HLD + c + 4);
      uint4 o;
      o.x = hopper::pack_bf16(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f));
      o.y = hopper::pack_bf16(fmaxf(a.z, 0.f), fmaxf(a.w, 0.f));
      o.z = hopper::pack_bf16(fmaxf(b.x, 0.f), fmaxf(b.y, 0.f));
      o.w = hopper::pack_bf16(fmaxf(b.z, 0.f), fmaxf(b.w, 0.f));
      reinterpret_cast<uint4*>(p.hidden + (row0 + r) * DH)[i % VPR] = o;
    }
  }

  // ---- head: out[:, 0:8] = bf16(hidden . W_out^T + b_out), the hidden
  // fragments rounded from h as above; out[:, 8:128] = 0
  if (warp < 4) {
    auto hid = [&](int r, int c) {
      return hopper::pack_bf16(fmaxf(hs[r * HLD + c], 0.f), fmaxf(hs[r * HLD + c + 1], 0.f));
    };
    float a4[4] = {0.f, 0.f, 0.f, 0.f};
    const int r = warp * 16 + g;
    for (int k0 = 0; k0 < DH; k0 += 16) {
      const __nv_bfloat16* bp = p.w_out + static_cast<size_t>(g) * DH + k0 + 2 * t;
      const int c = k0 + 2 * t;
      unsigned a[4] = {hid(r, c), hid(r + 8, c), hid(r, c + 8), hid(r + 8, c + 8)};
      mma_bf16(a4, a, ldg32(bp), ldg32(bp + 8));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = row0 + r + 8 * half;
      if (row < n) {
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(__fadd_rn(a4[2 * half], p.b_out[2 * t]));
        o.y = __float2bfloat16_rn(__fadd_rn(a4[2 * half + 1], p.b_out[2 * t + 1]));
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * 128 + 2 * t) = o;
      }
    }
  }
  for (int i = tid; i < BM * 15; i += THREADS) {
    const int r = i / 15, c = i % 15;
    if (row0 + r < n)
      reinterpret_cast<uint4*>(p.out + (row0 + r) * 128 + 8)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

bool shapes_ok(const Params& p) {
  return (p.d_hidden == 256 || p.d_hidden == 512) && p.k_in <= MAX_KIN && p.k_lat <= MAX_KLAT;
}

template <bool GATHER, int HN>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(resnetfc_wgmma<GATHER, HN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (p.n == 0) return 0;
  const unsigned grid = static_cast<unsigned>((p.n + BM - 1) / BM);
  resnetfc_wgmma<GATHER, HN><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATHER>
int dispatch(const Params& p, cudaStream_t stream) {
  return p.d_hidden == 512 ? launch_wgmma<GATHER, 256>(p, stream)
                           : launch_wgmma<GATHER, 128>(p, stream);
}

}  // namespace wg

bool shapes_ok(const Params& p) {
  return p.d_hidden > 0 && p.d_hidden <= MAXH && p.d_hidden % WN == 0 &&
         p.k_in % 16 == 0 && p.k_in >= 3 * p.n_aux && p.k_in <= MAXH &&
         p.k_lat % 16 == 0 && p.k_lat >= p.d_latent && p.d_latent + p.n_aux <= 128 &&
         p.k_lat <= 128;
}

// design 1: resnetfc_wgmma (quantized, wg::shapes_ok); 0: resnetfc_kernel
int dispatch(Params& p, int quantized, bool gather, int design, void* stream) {
  if (!shapes_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (!quantized || !wg::shapes_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
    return gather ? wg::dispatch<true>(p, s) : wg::dispatch<false>(p, s);
  }
  if (design != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (gather) return quantized ? launch<true, true>(p, s) : launch<false, true>(p, s);
  return quantized ? launch<true, false>(p, s) : launch<false, false>(p, s);
}

}  // namespace

// Weights as packed by ops/resnetfc_cuda.pack_resnetfc_params (its "kernel"
// entry), all contiguous; act_scales (2, 2*n_blocks) fp32 [xs; inv] or null
// for dynamic per-row scales; design 1 the wgmma kernel, 0 the first one.
// Returns the launch's cudaError_t.
extern "C" int resnetfc_int8_fwd(
    const void* zi, const void* w_in, const void* b_in, const void* wz,
    const void* bz, const void* wq, const void* ws, const void* bq,
    const void* w_out, const void* b_out, const void* act_scales, void* out,
    void* hidden, int n, int d_latent, int n_aux, int d_hidden, int n_blocks,
    int combine_layer, int k_in, int k_lat, int quantized, int design, void* stream) {
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
  return dispatch(p, quantized, false, design, stream);
}

// vox (cells, 8*d_latent) bf16 (vox_f32 = 0) or fp32 rows of the
// corner-expanded grid; flat (n,) int32; w8 (8, n) fp32; aux (n_aux, n) bf16.
extern "C" int gather_resnetfc_int8_fwd(
    const void* vox, const void* flat, const void* w8, const void* aux,
    const void* w_in, const void* b_in, const void* wz, const void* bz,
    const void* wq, const void* ws, const void* bq, const void* w_out,
    const void* b_out, const void* act_scales, void* out, void* hidden, int n,
    int d_latent, int n_aux, int d_hidden, int n_blocks, int combine_layer,
    int k_in, int k_lat, int quantized, int vox_f32, int design, void* stream) {
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
  return dispatch(p, quantized, true, design, stream);
}

EXPORT_ERROR_STRING
