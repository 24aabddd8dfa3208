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
// tensor cores, not memory, are the limit (989 TF/s bf16 on H100 SXM).
//
// Design: an implicit GEMM. M = output voxels, N = Cout, K = 27 taps x Cin.
// Each block of 4 warps owns a 64-voxel x 64-channel output tile and walks
// the 27 taps x 32-channel chunks of K. For each step it stages the 64
// shifted input rows (zero where the tap falls outside the volume: padding
// by bounds checks, no padded copy of the input) and the 32 x 64 weight
// slice in shared memory. In bf16 each warp multiplies a 32 x 32 part with
// WMMA 16x16x16 fragments that stay in registers for the whole K loop; in
// fp32 each thread keeps a 4 x 8 tile of plain FMAs (the tensor cores would
// round to TF32). The result goes through shared memory so that the bias
// add and the store are coalesced. This first version has no cp.async
// pipelining and no wgmma: loads and math do not overlap.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

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
conv3d_k3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int nb,
                 int D, int H, int W, int cin, int cout, bool vec_a,
                 bool vec_b) {
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
int launch(const void* x, const void* w, const void* bias, void* out, int nb,
           int d, int h, int wd, int cin, int cout, cudaStream_t stream) {
  constexpr int VN = Vec<T>::n;
  const bool vec_a = cin % VN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = cout % VN == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long m = static_cast<long long>(nb) * d * h * wd;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), (cout + BN - 1) / BN);
  conv3d_k3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), nb, d, h, wd, cin,
      cout, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (nb, d, h, w, cin), w (3, 3, 3, cin, cout) of one dtype, bias fp32 (cout)
// or null, out (nb, d, h, w, cout) in x's dtype; contiguous.
// Returns the launch's cudaError_t.
extern "C" int conv3d_k3_fwd(const void* x, const void* w, const void* bias,
                             void* out, int nb, int d, int h, int wd, int cin,
                             int cout, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w, bias, out, nb, d, h, wd, cin, cout, s);
  if (dtype == kFloat32)
    return launch<float>(x, w, bias, out, nb, d, h, wd, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

EXPORT_ERROR_STRING
