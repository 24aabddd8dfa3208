// 3-D convolution, kernel 3, stride 1, zero padding, NDHWC, for Hopper
// (sm_90a).
//
// Replaces: real_robot_nerf_actor_tpu/ops/conv3d_pallas.py:conv3d_k3_pallas
// (the Pallas kernel _kernel), dispatched by conv3d_k3.
//
// out[b,z,y,x,co] = bias[co] + sum over the 27 taps (dz,dy,dx) and ci of
//   x[b, z+dz-1, y+dy-1, x+dx-1, ci] * w[dz,dy,dx,ci,co]
// with x outside the volume read as zero. Weights keep the flax layout
// (3,3,3,Cin,Cout) as given. Products accumulate in fp32; the bias is added
// in fp32 and the sum is rounded once to the input's dtype.
//
// What bounds it on this card: the policy's `final` conv (100^3 voxels,
// 128 -> 64 channels) is 2*27*128*64 = 442k flops per voxel against 256+128
// bytes of input and output per voxel in bf16, over 1000 flops a byte: the
// tensor cores, not memory, are the limit (989 TF/s bf16 on H100 SXM),
// 0.447 ms for the call.
//
// bf16 with Cin a multiple of 64 and Cout a multiple of 8 (the policy's
// `final` conv): conv3d_k3_wgmma, an implicit GEMM with M = output voxels,
// N = Cout in tiles of 64, K = 27 taps x Cin, on wgmma with fp32
// accumulators in registers. Streaming the 27 shifted copies of the input
// from L2 (27x the input's bytes) is what held the first version back, so
// each block owns an output brick of x 16 x y 8 x z 2 = 256 voxels and loads
// the brick plus its one-voxel halo (18 x 10 x 4 voxels x 64 channels, 92 KB)
// once per 64-channel group with one 5-D TMA box, whose out-of-bounds zero
// fill is the zero padding. Two halo buffers: the next group's (or brick's)
// halo loads while the current one is multiplied. All 27 taps read the halo
// from shared memory: a tap is a row offset, different for each output row,
// so A goes to registers with ldmatrix (per-lane row addresses; the TMA's
// 128-byte swizzle puts the 16-byte chunks of 8 consecutive rows in 8
// different banks) and wgmma takes A from registers, loading the next tap's
// fragments while the current tap's products run, and one tap's products
// stay in flight while the next tap's are started. The weights, N contiguous
// (MN-major B), stream as 64 x 64 slices per (tap, channel group) through a
// 4-stage TMA ring. Two consumer warpgroups (128 rows each) and one producer
// warp; persistent blocks, one per SM, walk the (brick, N-tile) items, so
// one brick's epilogue overlaps the next one's loads. Outputs past the
// volume's edge (bricks run past 100 in x and y) are not stored. Shared
// memory: 2 x 92 KB of halo + 4 x 8 KB of weights.
//
// Every other call (fp32, or Cin not a multiple of 64: the card tests' Cin
// 12 and 40) runs conv3d_k3_simt, the first version: a 64-voxel x 64-channel
// tile per 4-warp block walking the 27 taps x 32-channel chunks of K, the
// shifted rows and the weight slice staged in shared memory, WMMA in bf16
// and plain FMAs in fp32 (the tensor cores would round to TF32).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.996 ms
// for the `final` conv (two CUDA events; 1.09 ms of device time under
// torch.profiler) against 1.147 ms for torch's F.conv3d, 5.327 ms for the
// first version and a bound of 0.447 ms; 3.28x the input's bytes loaded
// (27x before). PERF.md, kernel table row 2.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output voxels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 128;  // 4 warps
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3d_k3_simt(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, int nb,
               int D, int H, int W, int cin, int cout, bool vec_a, bool vec_b) {
  __shared__ __align__(128) T As[BM * LDA];
  __shared__ __align__(128) T Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ int rb[BM], rz[BM], ry[BM], rx[BM];

  const long long M = static_cast<long long>(nb) * D * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < M) {
      long long t = m;
      rx[tid] = static_cast<int>(t % W);
      t /= W;
      ry[tid] = static_cast<int>(t % H);
      t /= H;
      rz[tid] = static_cast<int>(t % D);
      rb[tid] = static_cast<int>(t / D);
    } else {
      rb[tid] = -1;
    }
  }

  // bf16: warp tile 32x32 as 2x2 WMMA fragments; fp32: 4x8 per thread
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
  float acc[4][8];
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 32;
  const int ty = tid / 8;
  const int tx = tid % 8;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  constexpr int VN = Vec<T>::n;
  for (int tap = 0; tap < 27; ++tap) {
    const int dz = tap / 9 - 1;
    const int dy = (tap / 3) % 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      // ---- A: BM shifted input rows x BK channels (zero outside)
      if (vec_a) {
        for (int i = tid; i < BM * (BK / VN); i += THREADS) {
          const int r = i / (BK / VN);
          const int c = (i % (BK / VN)) * VN;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          const int b = rb[r];
          const int zz = rz[r] + dz, yy = ry[r] + dy, xx = rx[r] + dx;
          if (b >= 0 && zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 &&
              xx < W && c0 + c < cin)
            val = *reinterpret_cast<const uint4*>(
                x + (((static_cast<size_t>(b) * D + zz) * H + yy) * W + xx) * cin +
                c0 + c);
          *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
        }
      } else {
        for (int i = tid; i < BM * BK; i += THREADS) {
          const int r = i / BK;
          const int c = i % BK;
          T val = from_f32<T>(0.f);
          const int b = rb[r];
          const int zz = rz[r] + dz, yy = ry[r] + dy, xx = rx[r] + dx;
          if (b >= 0 && zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 &&
              xx < W && c0 + c < cin)
            val = x[(((static_cast<size_t>(b) * D + zz) * H + yy) * W + xx) * cin +
                    c0 + c];
          As[r * LDA + c] = val;
        }
      }
      // ---- B: weight rows (tap, c0..c0+BK) x cols (n0..n0+BN)
      const T* wt = w + (static_cast<size_t>(tap) * cin + c0) * cout + n0;
      if (vec_b) {
        for (int i = tid; i < BK * (BN / VN); i += THREADS) {
          const int r = i / (BN / VN);
          const int c = (i % (BN / VN)) * VN;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (c0 + r < cin && n0 + c < cout)
            val = *reinterpret_cast<const uint4*>(wt + static_cast<size_t>(r) * cout + c);
          *reinterpret_cast<uint4*>(Bs + r * LDB + c) = val;
        }
      } else {
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN;
          const int c = i % BN;
          T val = from_f32<T>(0.f);
          if (c0 + r < cin && n0 + c < cout) val = wt[static_cast<size_t>(r) * cout + c];
          Bs[r * LDB + c] = val;
        }
      }
      __syncthreads();

      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(af[i], As + (wr + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(bf[j], Bs + kk * 16 * LDB + wc + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(cf[i][j], af[i], bf[j], cf[i][j]);
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], b[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = to_f32(As[(ty * 4 + i) * LDA + kk]);
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = to_f32(Bs[kk * LDB + tx * 8 + j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue through shared memory: + bias (fp32), round once, store
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr + i * 16) * LDC + wc + j * 16, cf[i][j],
                                LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * LDC + tx * 8 + j] = acc[i][j];
  }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN;
    const int n = i % BN;
    const long long m = m0 + r;
    const int co = n0 + n;
    if (m < M && co < cout) {
      const float bv = bias != nullptr ? bias[co] : 0.f;
      out[m * cout + co] = from_f32<T>(Cs[r * LDC + n] + bv);
    }
  }
}

template <typename T>
int launch_simt(const void* x, const void* w, const void* bias, void* out, int nb,
                int d, int h, int wd, int cin, int cout, cudaStream_t stream) {
  constexpr int VN = Vec<T>::n;
  const bool vec_a = cin % VN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = cout % VN == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long m = static_cast<long long>(nb) * d * h * wd;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), (cout + BN - 1) / BN);
  conv3d_k3_simt<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), nb, d, h, wd, cin,
      cout, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}


// ============================================================ wgmma (bf16)
namespace wg {

constexpr int BX = 16, BY = 8, BZ = 2;                  // output brick
constexpr int HX = BX + 2, HY = BY + 2, HZ = BZ + 2;    // with its halo
constexpr int HALO_BYTES = HX * HY * HZ * 128;          // 64 bf16 a row: 92160
constexpr int WSTAGES = 4;
constexpr int W_BYTES = 64 * 64 * 2;                    // (64 ci) x (64 co)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;
constexpr int OFF_W = 2 * HALO_BYTES;
constexpr int OFF_BAR = OFF_W + WSTAGES * W_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + (4 + 2 * WSTAGES) * 8 + 1024;

struct Params {
  __nv_bfloat16* out;
  const float* bias;
  int d, h, w, cin, cout;
  int nbx, nby, nbz, ntiles;
  long long items;
};

struct Item {
  int nt, bx, by, bz, b;
};

__device__ __forceinline__ Item decode(long long it, const Params& p) {
  Item r;
  r.nt = static_cast<int>(it % p.ntiles);
  it /= p.ntiles;
  r.bx = static_cast<int>(it % p.nbx);
  it /= p.nbx;
  r.by = static_cast<int>(it % p.nby);
  it /= p.nby;
  r.bz = static_cast<int>(it % p.nbz);
  r.b = static_cast<int>(it / p.nbz);
  return r;
}

using Frag = uint32_t[2][4][4];  // [m-tile][k16 slice][register]

__global__ void __launch_bounds__(THREADS, 1)
conv3d_k3_wgmma(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wring = smem + OFF_W;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* halo_full = bars;
  uint64_t* halo_empty = bars + 2;
  uint64_t* w_full = bars + 4;
  uint64_t* w_empty = w_full + WSTAGES;

  const int tid = threadIdx.x;
  const int groups = p.cin / 64;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&halo_full[i], 1);
      hopper::mbar_init(&halo_empty[i], CONSUMERS);
    }
    for (int i = 0; i < WSTAGES; ++i) {
      hopper::mbar_init(&w_full[i], 1);
      hopper::mbar_init(&w_empty[i], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer: one thread starts every TMA load
    if (tid != CONSUMERS) return;
    int hl = 0, wl = 0;
    auto load_halo = [&](long long it, int g) {
      const Item t = decode(it, p);
      const int buf = hl & 1;
      if (hl >= 2) hopper::mbar_wait(&halo_empty[buf], ((hl >> 1) - 1) & 1);
      hopper::mbar_expect_tx(&halo_full[buf], HALO_BYTES);
      hopper::tma_load_5d(smem + buf * HALO_BYTES, &tm_x, &halo_full[buf], g * 64,
                          t.bx * BX - 1, t.by * BY - 1, t.bz * BZ - 1, t.b);
      ++hl;
    };
    if (blockIdx.x < p.items) load_halo(blockIdx.x, 0);
    for (long long it = blockIdx.x; it < p.items; it += gridDim.x) {
      const int nt = static_cast<int>(it % p.ntiles);
      for (int g = 0; g < groups; ++g) {
        const bool last = g + 1 == groups;
        const long long next_it = last ? it + gridDim.x : it;
        for (int tap = 0; tap < 27; ++tap) {
          const int st = wl % WSTAGES;
          if (wl >= WSTAGES) hopper::mbar_wait(&w_empty[st], ((wl / WSTAGES) - 1) & 1);
          // the consumers have released this group's first weight slice, so
          // they are done with the previous group's halo buffer: refill it
          if (tap == WSTAGES && next_it < p.items) load_halo(next_it, last ? 0 : g + 1);
          hopper::mbar_expect_tx(&w_full[st], W_BYTES);
          hopper::tma_load_2d(wring + st * W_BYTES, &tm_w, &w_full[st], nt * 64,
                              tap * p.cin + g * 64);
          ++wl;
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup cw owns brick rows [128 cw, 128 cw + 128)
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g8 = lane >> 2, qd = lane & 3;
  // ldmatrix: lane gives row (lane & 7) + 8 * ((lane >> 3) & 1) of the warp's
  // 16 rows (x), 16-byte chunk (lane >> 4) of each k16 slice. The warp's rows
  // of m-tile mt are one x line of the brick: z = line / 8, y = line % 8.
  const int lx = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lk = lane >> 4;
  int row0[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int line = cw * 8 + mt * 4 + warp;
    row0[mt] = ((line >> 3) * HY + (line & 7)) * HX + lx;
  }

  int hl = 0, wl = 0;
  float acc[2][32];
  Frag fa, fb;

  for (long long it = blockIdx.x; it < p.items; it += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

    for (int g = 0; g < groups; ++g) {
      const int buf = hl & 1;
      hopper::mbar_wait(&halo_full[buf], (hl >> 1) & 1);
      const uint32_t halo = hopper::smem_u32(smem + buf * HALO_BYTES);

      auto load_a = [&](Frag& a, int tap) {
        const int off = ((tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = row0[mt] + off;
          const uint32_t ra = halo + r * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::ldmatrix_x4(a[mt][kk], ra + (((2 * kk + lk) ^ (r & 7)) << 4));
        }
      };
      auto keep = [&](Frag& a) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[mt][kk]);
      };
      // start one tap's products from `cur`; then wait for the previous
      // tap's (one group stays in flight, so the tensor cores never drain
      // between taps), release its weight slice and load the next tap's A
      // into `nxt`, the registers that tap read
      auto step = [&](Frag& cur, Frag& nxt, int tap) {
        const int st = wl % WSTAGES;
        hopper::mbar_wait(&w_full[st], (wl / WSTAGES) & 1);
        const uint64_t db = hopper::desc_sw128(wring + st * W_BYTES);
        hopper::wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_rs_64x64x16_tb(acc[mt], cur[mt][kk], db + kk * (16 * 128 >> 4));
        hopper::wgmma_commit();
        if (tap > 0) {
          hopper::wgmma_wait<1>();
          keep(nxt);
          hopper::mbar_arrive(&w_empty[(wl - 1) % WSTAGES]);
        }
        if (tap + 1 < 27) load_a(nxt, tap + 1);
        ++wl;
      };

      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      load_a(fa, 0);
      for (int tap = 0; tap < 26; tap += 2) {
        step(fa, fb, tap);
        step(fb, fa, tap + 1);
      }
      step(fa, fb, 26);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      keep(fa);
      hopper::mbar_arrive(&w_empty[(wl - 1) % WSTAGES]);
      hopper::mbar_arrive(&halo_empty[buf]);
      ++hl;
    }

    // epilogue: + bias (fp32), one rounding to bf16, stores inside the volume
    const Item t = decode(it, p);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int line = cw * 8 + mt * 4 + warp;
      const int z = t.bz * BZ + (line >> 3);
      const int y = t.by * BY + (line & 7);
      if (z >= p.d || y >= p.h) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int x = t.bx * BX + g8 + 8 * hf;
        if (x >= p.w) continue;
        __nv_bfloat16* orow =
            p.out + (((static_cast<long long>(t.b) * p.d + z) * p.h + y) * p.w + x) *
                        p.cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = t.nt * 64 + 8 * j + 2 * qd;
          if (co >= p.cout) continue;
          const float b0 = p.bias != nullptr ? p.bias[co] : 0.f;
          const float b1 = p.bias != nullptr ? p.bias[co + 1] : 0.f;
          *reinterpret_cast<uint32_t*>(orow + co) = hopper::pack_bf16(
              acc[mt][4 * j + 2 * hf] + b0, acc[mt][4 * j + 2 * hf + 1] + b1);
        }
      }
    }
  }
}

int launch(const void* x, const void* w, const void* bias, void* out, int nb, int d,
           int h, int wd, int cin, int cout, cudaStream_t stream) {
  static bool attr_set = false;  // once per kernel, not per launch
  static int sms = 0;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3d_k3_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tm_x, tm_w;
  const uint64_t c2 = static_cast<uint64_t>(cin) * 2;
  const uint64_t xdims[5] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(wd),
                             static_cast<uint64_t>(h), static_cast<uint64_t>(d),
                             static_cast<uint64_t>(nb)};
  const uint64_t xstrides[4] = {c2, c2 * wd, c2 * wd * h, c2 * wd * h * d};
  const uint32_t xbox[5] = {64, HX, HY, HZ, 1};
  int r = encode_bf16_sw128(&tm_x, const_cast<void*>(x), 5, xdims, xstrides, xbox);
  if (r != 0) return r;
  const uint64_t wdims[2] = {static_cast<uint64_t>(cout), 27ull * cin};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(cout) * 2};
  const uint32_t wbox[2] = {64, 64};
  r = encode_bf16_sw128(&tm_w, const_cast<void*>(w), 2, wdims, wstrides, wbox);
  if (r != 0) return r;
  Params p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bias = static_cast<const float*>(bias);
  p.d = d;
  p.h = h;
  p.w = wd;
  p.cin = cin;
  p.cout = cout;
  p.nbx = (wd + BX - 1) / BX;
  p.nby = (h + BY - 1) / BY;
  p.nbz = (d + BZ - 1) / BZ;
  p.ntiles = (cout + 63) / 64;
  p.items = static_cast<long long>(p.ntiles) * p.nbx * p.nby * p.nbz * nb;
  const unsigned grid = static_cast<unsigned>(p.items < sms ? p.items : sms);
  conv3d_k3_wgmma<<<grid, THREADS, SMEM_BYTES, stream>>>(tm_x, tm_w, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// x (nb, d, h, w, cin), w (3, 3, 3, cin, cout) of one dtype, bias fp32 (cout)
// or null, out (nb, d, h, w, cout) in x's dtype; contiguous. The first
// version, any cin and cout. Returns the launch's cudaError_t.
extern "C" int conv3d_k3_fwd(const void* x, const void* w, const void* bias,
                             void* out, int nb, int d, int h, int wd, int cin,
                             int cout, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_simt<__nv_bfloat16>(x, w, bias, out, nb, d, h, wd, cin, cout, s);
  if (dtype == kFloat32)
    return launch_simt<float>(x, w, bias, out, nb, d, h, wd, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same call in bf16 on conv3d_k3_wgmma: cin a multiple of 64, cout a
// multiple of 8, x and w 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int conv3d_k3_wgmma_fwd(const void* x, const void* w, const void* bias,
                                   void* out, int nb, int d, int h, int wd, int cin,
                                   int cout, void* stream) {
  if (cin % 64 != 0 || cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch(x, w, bias, out, nb, d, h, wd, cin, cout,
                    static_cast<cudaStream_t>(stream));
}

EXPORT_ERROR_STRING
