// Flash attention forward for Hopper (sm_90a), head dim 64.
//
// Replaces: real_robot_nerf_actor_tpu/ops/attention_pallas.py:flash_attention
// (the Pallas kernel _flash_kernel).
//
// Computes softmax(q k^T * scale) v for q (B, H, Nq, 64) and k, v (B, H, Nk,
// 64), each with any strides whose last one is 1, into an output of the
// caller's layout, with the arithmetic of the TPU kernel: fp32 scores times
// the scale, keys >= Nk masked to -0.7 * FLT_MAX, an online softmax with a
// running max m, sum l and accumulator in fp32, the probabilities rounded to
// v's dtype before P.V, a guard for l == 0, and the output in q's dtype.
// (The bf16 kernel keeps the scores in log2 units, scale * log2(e), and
// takes exp2: the same function in another rounding.)
//
// What bounds it on this card: at the policy's shapes (2048 x 8077,
// 8 x 2048 x 2048 and 8077 x 2048, d = 64) the work is 4*Nq*Nk*64 flops
// against reading q, k, v and writing o once, some 500 flops a byte in bf16:
// the tensor cores are the limit (989 TF/s bf16 on H100 SXM), 0.0607 ms for
// the act step's 8 calls.
//
// bf16 (every call of the policy): flash_fwd_wgmma. A block of two consumer
// warpgroups (64 query rows each) and one producer warp. The producer loads
// the block's 128 q rows once and streams 64-key K and V tiles through a
// 3-stage ring with TMA (128-byte swizzle), signalling "full" mbarriers; the
// consumers release each stage on an "empty" mbarrier. S = Q K^T is wgmma
// m64n64k16 from shared memory (K key-major, d contiguous: K-major); the fp32
// scores become bf16 A fragments in registers, and P.V is wgmma with A from
// registers and V read MN-major (transpose flag of B): no score tile in
// shared memory. The softmax folds the scale into one multiply-add before
// ex2.approx, and the QK^T of tile i goes to the tensor cores with the P.V
// of tile i - 1, so the softmax of tile i overlaps that product. TMA fills
// keys past Nk with zeros, which score 0, so the last tile is masked in
// registers. Calls whose q tiles cannot fill the card (1 x 2048 queries: 16
// blocks of 128 rows) split the key range: each split writes its (m, l,
// acc) in fp32 to scratch the wrapper allocates, and flash_combine merges
// the splits and normalises. The wrapper picks the split count (plan_splits
// in ops/attention_cuda.py).
//
// fp32 (off the main path): flash_fwd_simt, one 4-warp block per 64-row q
// tile with plain FMAs (the tensor cores would round the inputs to TF32).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (device
// time from torch.profiler, split combine included): 19.2 us for
// 1 x 2048 x 8077 (8 splits), 28.5 us for 8 x 2048 x 2048, 18.5 us for
// 1 x 8077 x 2048 (2 splits), 0.209 ms per act step against 0.239 ms for
// torch's scaled_dot_product_attention and a bound of 0.061 ms. One call
// timed alone (two CUDA events) reads ~0.06 ms: the host's launch path, not
// the kernel. PERF.md, kernel table row 1.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 64;  // head dim
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

struct Strides {
  long long b, h, n;  // elements; the last dim has stride 1
};

// ================================================================ bf16
constexpr int BQ = 128;     // query rows per block (two warpgroups)
constexpr int BKV = 64;     // keys per tile
constexpr int STAGES = 3;   // K/V ring
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int TILE_BYTES = BKV * D * 2;  // 8 KB
constexpr int Q_BYTES = BQ * D * 2;      // 16 KB
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * TILE_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 16 * 8 + 1024;  // + alignment slack

struct WgmmaParams {
  __nv_bfloat16* o;
  Strides so;
  float* part_o;    // (splits, B*H, nq, 64) fp32, or null
  float2* part_ml;  // (splits, B*H, nq) (m in log2 units, l), or null
  int heads, nq, nk, tiles_per_split;
  float scale_log2;
};

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const WgmmaParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.z;
  const int n_tiles = (p.nk + BKV - 1) / BKV;
  const int t0 = split * p.tiles_per_split;
  const int ntl = min(n_tiles, t0 + p.tiles_per_split) - t0;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warp: one thread starts every TMA load
    if (tid == CONSUMERS) {
      hopper::mbar_expect_tx(q_full, Q_BYTES);
      hopper::tma_load_4d(Qs, &tm_q, q_full, 0, q0, h, b);
      for (int i = 0; i < ntl; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        const int kv0 = (t0 + i) * BKV;
        hopper::mbar_expect_tx(&k_full[s], TILE_BYTES);
        hopper::tma_load_4d(Ks + s * BKV * D, &tm_k, &k_full[s], 0, kv0, h, b);
        hopper::mbar_expect_tx(&v_full[s], TILE_BYTES);
        hopper::tma_load_4d(Vs + s * BKV * D, &tm_v, &v_full[s], 0, kv0, h, b);
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64)
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8

  hopper::mbar_wait(q_full, 0);
  const uint64_t dq = hopper::desc_sw128(Qs + wg * 64 * D);

  using PFrag = uint32_t[4][4];  // P of one tile: four k16 A fragments
  float sc[32];                  // scores of one tile, rows g / g + 8,
                                 // cols 8j + 2qd + {0, 1}

  // S = Q K^T of tile i, started (not waited for)
  auto start_qk = [&](int i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&k_full[s], (i / STAGES) & 1);
    const uint64_t dk = hopper::desc_sw128(Ks + s * BKV * D);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss_64x64x16(sc, dq + 2 * kk, dk + 2 * kk, kk);
    hopper::wgmma_commit();
  };
  // acc += P V of tile i, started
  auto start_pv = [&](int i, PFrag& pa) {
    const int s = i % STAGES;
    hopper::mbar_wait(&v_full[s], (i / STAGES) & 1);
    const uint64_t dv = hopper::desc_sw128(Vs + s * BKV * D);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs_64x64x16_tb(o, pa[kk], dv + kk * (16 * 128 >> 4));
    hopper::wgmma_commit();
  };
  // after the wait for P V of tile i: keep its registers to here, free the stage
  auto retire_pv = [&](int i, PFrag& pa) {
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
    hopper::mbar_arrive(&empty[i % STAGES]);
  };
  // online softmax of tile i's scores: mask the keys past nk (TMA read them
  // as zeros), new row max of the scaled scores, P = 2^(s * scale * log2(e)
  // - m) in one multiply-add, in fp32 (summed into l) rounded to
  // bf16 A fragments (k16 slice kk = score cols 16kk .. 16kk + 15, the n8
  // chunks 2kk and 2kk + 1); returns the factors that rescale acc
  auto softmax = [&](int i, PFrag& pa, float& alpha0, float& alpha1) {
    hopper::fence_regs(sc);
    const int kv0 = (t0 + i) * BKV;
    const bool tail = kv0 + BKV > p.nk;
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (tail && kv0 + 8 * j + 2 * qd + e >= p.nk)
          sc[4 * j + e] = sc[4 * j + 2 + e] = MASK_VALUE;
        mx0 = fmaxf(mx0, sc[4 * j + e]);
        mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the scale is positive: the max of the scaled scores is the scaled max
    const float mn0 = fmaxf(m0, mx0 * p.scale_log2), mn1 = fmaxf(m1, mx1 * p.scale_log2);
    alpha0 = hopper::exp2_approx(m0 - mn0);
    alpha1 = hopper::exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf;
        const float p0 = hopper::exp2_approx(fmaf(sc[4 * j], p.scale_log2, -m0));
        const float p1 = hopper::exp2_approx(fmaf(sc[4 * j + 1], p.scale_log2, -m0));
        const float p2 = hopper::exp2_approx(fmaf(sc[4 * j + 2], p.scale_log2, -m1));
        const float p3 = hopper::exp2_approx(fmaf(sc[4 * j + 3], p.scale_log2, -m1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[kk][2 * hf] = hopper::pack_bf16(p0, p1);
        pa[kk][2 * hf + 1] = hopper::pack_bf16(p2, p3);
      }
    }
  };
  // tile i: S_i = Q K_i^T and acc += P_{i-1} V_{i-1} go to the tensor cores
  // together, the softmax of S_i runs while P_{i-1} V_{i-1} does, then acc
  // takes tile i's rescale
  auto step = [&](int i, PFrag& prev, PFrag& cur) {
    start_qk(i);
    start_pv(i - 1, prev);
    hopper::wgmma_wait<1>();
    float alpha0, alpha1;
    softmax(i, cur, alpha0, alpha1);
    hopper::wgmma_wait<0>();
    retire_pv(i - 1, prev);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
  };
  auto last_pv = [&](int i, PFrag& pa) {
    start_pv(i, pa);
    hopper::wgmma_wait<0>();
    retire_pv(i, pa);
  };

  PFrag pa0, pa1;
  {
    float alpha0, alpha1;  // acc is still zero: nothing to rescale
    start_qk(0);
    hopper::wgmma_wait<0>();
    softmax(0, pa0, alpha0, alpha1);
  }
  for (int i = 1;; i += 2) {
    if (i >= ntl) {
      last_pv(i - 1, pa0);
      break;
    }
    step(i, pa0, pa1);
    if (i + 1 >= ntl) {
      last_pv(i, pa1);
      break;
    }
    step(i + 1, pa1, pa0);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const int r0 = q0 + wg * 64 + warp * 16 + g;
  if (p.part_o == nullptr) {
    const float inv0 = (l0 == 0.f) ? 1.f : 1.f / l0;
    const float inv1 = (l1 == 0.f) ? 1.f : 1.f / l1;
    __nv_bfloat16* ob = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r >= p.nq) continue;
      const float inv = hf ? inv1 : inv0;
      __nv_bfloat16* orow = ob + r * p.so.n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * qd) = hopper::pack_bf16(
            o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    }
  } else {
    const size_t base = (static_cast<size_t>(split) * gridDim.y + bh) * p.nq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r >= p.nq) continue;
      float* prow = p.part_o + (base + r) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(prow + 8 * j + 2 * qd) =
            make_float2(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
      if (qd == 0) p.part_ml[base + r] = hf ? make_float2(m1, l1) : make_float2(m0, l0);
    }
  }
}

// Merges the key splits of flash_fwd_wgmma: m = max m_s, l = sum l_s 2^(m_s - m),
// o = sum acc_s 2^(m_s - m) / l (1 where l == 0). Eight threads per row.
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
              __nv_bfloat16* __restrict__ o, Strides so, int heads, int bh_total,
              int nq, int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx >> 3;
  const int cg = static_cast<int>(idx & 7);
  if (row >= static_cast<long long>(bh_total) * nq) return;
  const size_t stride = static_cast<size_t>(bh_total) * nq;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[s * stride + row].x);
  float l = 0.f, acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[s * stride + row];
    const float w = hopper::exp2_approx(ml.x - mx);
    l += ml.y * w;
    const float4* src = reinterpret_cast<const float4*>(part_o + (s * stride + row) * D + cg * 8);
    const float4 a = src[0], c = src[1];
    acc[0] += w * a.x; acc[1] += w * a.y; acc[2] += w * a.z; acc[3] += w * a.w;
    acc[4] += w * c.x; acc[5] += w * c.y; acc[6] += w * c.z; acc[7] += w * c.w;
  }
  const float inv = (l == 0.f) ? 1.f : 1.f / l;
  const int bh = static_cast<int>(row / nq), r = static_cast<int>(row % nq);
  uint4 out;
  out.x = hopper::pack_bf16(acc[0] * inv, acc[1] * inv);
  out.y = hopper::pack_bf16(acc[2] * inv, acc[3] * inv);
  out.z = hopper::pack_bf16(acc[4] * inv, acc[5] * inv);
  out.w = hopper::pack_bf16(acc[6] * inv, acc[7] * inv);
  *reinterpret_cast<uint4*>(o + (bh / heads) * so.b + (bh % heads) * so.h + r * so.n +
                            cg * 8) = out;
}

// =============================================================== fp32
constexpr int S_THREADS = 128;  // 4 warps
constexpr int S_BQ = 64;
constexpr int S_BKV = 64;
constexpr int LDT = D + 8;      // row stride (elements) of the staged tiles
constexpr int LDS = S_BKV + 4;  // row stride of the score tile

// rows [0, rows_valid) of a (64, D) tile with the given row stride, zeros beyond
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows_valid) {
  for (int i = threadIdx.x; i < 64 * (D / 4); i += S_THREADS) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDT + c) = val;
  }
}

constexpr size_t S_SMEM = static_cast<size_t>(S_BQ * LDT + 2 * S_BKV * LDT +
                                              S_BQ * LDT + S_BQ * LDS) * sizeof(float);

__global__ void __launch_bounds__(S_THREADS)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, Strides sq,
               Strides sk, Strides sv, Strides so, int heads, int nq, int nk,
               float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + S_BQ * LDT;
  float* Vs = Ks + S_BKV * LDT;
  float* Ps = Vs + S_BKV * LDT;
  float* Ss = Ps + S_BQ * LDT;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * S_BQ;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  load_tile(Qs, q + b * sq.b + h * sq.h + q0 * sq.n, sq.n, nq - q0);

  const int tid = threadIdx.x;
  const int row = tid >> 1;  // this thread's query row
  const int half = tid & 1;  // ... and its 32 columns
  float m_i = -INFINITY, l_i = 0.f, acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  for (int kv0 = 0; kv0 < nk; kv0 += S_BKV) {
    load_tile(Ks, kb + kv0 * sk.n, sk.n, nk - kv0);
    load_tile(Vs, vb + kv0 * sv.n, sv.n, nk - kv0);
    __syncthreads();
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += Qs[row * LDT + d] * Ks[col * LDT + d];
      Ss[row * LDS + col] = s;
    }
    __syncthreads();

    // online softmax over this tile; two threads per row
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
    float* prow = Ps + row * LDT + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pv = expf(srow[c] - m_next);
      lsum += pv;
      prow[c] = pv;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l_i = alpha * l_i + lsum;
    m_i = m_next;
    __syncthreads();

    float pv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) pv[c] = 0.f;
    for (int kk = 0; kk < S_BKV; ++kk) {
      const float pk = Ps[row * LDT + kk];
      const float* vr = Vs + kk * LDT + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) pv[c] += pk * vr[c];
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = acc[c] * alpha + pv[c];
    __syncthreads();
  }

  if (q0 + row < nq) {
    const float inv = (l_i == 0.f) ? 1.f : 1.f / l_i;
    float* orow = o + b * so.b + h * so.h + (q0 + row) * so.n + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) orow[c] = acc[c] * inv;
  }
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* part_o, float2* part_ml, int nb, int heads, int nq, int nk,
                int splits, int tiles_per_split, const Strides* st, float scale,
                cudaStream_t stream) {
  static bool attr_set = false;  // once per kernel, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {nq, nk, nk};
  const uint32_t box_rows[3] = {BQ, BKV, BKV};
  for (int t = 0; t < 3; ++t) {
    const uint64_t dims[4] = {D, static_cast<uint64_t>(rows[t]),
                              static_cast<uint64_t>(heads), static_cast<uint64_t>(nb)};
    const uint64_t strides[3] = {static_cast<uint64_t>(st[t].n) * 2,
                                 static_cast<uint64_t>(st[t].h) * 2,
                                 static_cast<uint64_t>(st[t].b) * 2};
    const uint32_t box[4] = {D, box_rows[t], 1, 1};
    const int r = encode_bf16_sw128(&maps[t], const_cast<void*>(ptrs[t]), 4, dims,
                                    strides, box);
    if (r != 0) return r;
  }
  WgmmaParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.so = st[3];
  p.part_o = splits > 1 ? part_o : nullptr;
  p.part_ml = splits > 1 ? part_ml : nullptr;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.tiles_per_split = tiles_per_split;
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((nq + BQ - 1) / BQ, nb * heads, splits);
  flash_fwd_wgmma<<<grid, THREADS, SMEM_BYTES, stream>>>(maps[0], maps[1], maps[2], p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long threads = static_cast<long long>(nb) * heads * nq * 8;
  flash_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(o), st[3], heads, nb * heads, nq,
      splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int nb,
               int heads, int nq, int nk, const Strides* st, float scale,
               cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((nq + S_BQ - 1) / S_BQ, nb * heads);
  flash_fwd_simt<<<grid, S_THREADS, S_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2], st[3],
      heads, nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nb, heads, nq, 64), k/v (nb, heads, nk, 64), o (nb, heads, nq, 64), one
// dtype, each with element strides (b, h, n) in `strides` (q, k, v, o: 12
// values) and a last stride of 1. bf16 runs flash_fwd_wgmma with `splits`
// key splits of `tiles_per_split` 64-key tiles (part_o / part_ml: fp32
// scratch of splits * nb * heads * nq * (64 | 2) values when splits > 1);
// fp32 runs flash_fwd_simt. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* part_o, void* part_ml, int nb,
                                   int heads, int nq, int nk, int splits,
                                   int tiles_per_split, const long long* strides,
                                   float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  if (dtype == kBFloat16)
    return launch_bf16(q, k, v, o, static_cast<float*>(part_o),
                       static_cast<float2*>(part_ml), nb, heads, nq, nk, splits,
                       tiles_per_split, st, scale, s);
  if (dtype == kFloat32) return launch_f32(q, k, v, o, nb, heads, nq, nk, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

EXPORT_ERROR_STRING
