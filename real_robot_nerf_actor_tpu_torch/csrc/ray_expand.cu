// Ray -> per-sample field expansion for the int8 serving renderer.
//
// Replaces the JAX package's `ops/ray_expand_pallas.py` (`ray_expand`, the
// Pallas kernel `_kernel`). For rays (R, 8) [o, d, near, far] and depths
// z (R, K), in K-major sample order, it writes
//
//   auxT  (6 + 3F, K, R) bf16  [canon(3) | dirs(3) | wrapped phases(3F)]
//   w8T   (8, K, R)      f32   lerp weight x in-bounds mask of each corner
//   flatT (K, R)         i32   base row in the corner-expanded (+1-padded) grid
//
// with exactly the arithmetic of `ray_expand_plain` (ops/ray_expand_cuda.py):
// every product, quotient, sum and difference is a separate round-to-nearest
// operation (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn), so nvcc cannot
// contract any of them into a fused multiply-add, and the result equals the
// torch elementwise ops bit for bit.
//
// What bounds it on an H100: 32 bytes of ray and 4 bytes of z in, 84 bytes
// out per sample (F = 6) against ~120 flops: memory (3.35 TB/s), and at the
// renderer's 65536 samples a call (5.5 MB) the launch itself.
//
// Design: a block takes 32 rays x 8 samples. Its rays (1 KB) and its z
// tile are read once, by consecutive threads at consecutive addresses, into
// shared memory, transposed so that each thread then reads its ray's
// components without bank conflicts. Each of the 256 threads computes one
// (ray, sample), a warp the 32 rays of one sample, so every store of a warp
// fills a whole row segment of a (c, k) plane: 128 bytes of w8T and flatT,
// 64 of auxT. The grid is (R / 32, ceil(K / 8)): 256 blocks at 4096 x 16,
// 16 warps an SM, which hide the latency of the IEEE divisions (21 a
// sample) behind each other.
#include "common.cuh"

namespace {

constexpr int RB = 32;              // rays of a block
constexpr int KB = 8;               // samples of a block
constexpr int NT = RB * KB;         // threads: one (ray, sample) each

struct Params {
  const float* rays;
  const float* z;
  __nv_bfloat16* aux;
  float* w8;
  int* flat;
  int R, K, D, H, W, num_freqs;
  float lo[3], ext[3], freq, two_pi;
};

struct Sample {
  float canon[3];
  float w8[8];
  int flat;
};

__device__ __forceinline__ Sample expand(const Params& p, const float o[3], const float d[3],
                                         float z) {
  Sample s;
  const int dims[3] = {p.W, p.H, p.D};     // canon[0] indexes W (torch convention)
  float t[3];
  int b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.canon[i] = __fdiv_rn(__fsub_rn(__fadd_rn(o[i], __fmul_rn(z, d[i])), p.lo[i]), p.ext[i]);
    const float g = __fmul_rn(s.canon[i], static_cast<float>(dims[i] - 1));
    const float g0 = floorf(g);
    t[i] = __fsub_rn(g, g0);
    b[i] = __float2int_rz(g0);             // saturates outside the int32 range
  }
  // corner c = dz*4 + dy*2 + dx: in bounds where 0 <= b + delta < dim,
  // tested on b itself so that a saturated b cannot overflow
  bool in[3][2];
  float w[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    in[i][0] = b[i] >= 0 && b[i] < dims[i];
    in[i][1] = b[i] >= -1 && b[i] < dims[i] - 1;
    w[i][0] = __fsub_rn(1.f, t[i]);
    w[i][1] = t[i];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
    const float inb = (in[2][dz] && in[1][dy] && in[0][dx]) ? 1.f : 0.f;
    s.w8[c] = __fmul_rn(__fmul_rn(__fmul_rn(w[2][dz], w[1][dy]), w[0][dx]), inb);
  }
  const int xc = min(max(b[0], -1), p.W - 1) + 1;
  const int yc = min(max(b[1], -1), p.H - 1) + 1;
  const int zc = min(max(b[2], -1), p.D - 1) + 1;
  s.flat = (zc * (p.H + 1) + yc) * (p.W + 1) + xc;
  return s;
}

// t - 2*pi * rint(t / 2*pi), rint rounding half to even as torch.round
__device__ __forceinline__ float wrap(float t, float two_pi) {
  return __fsub_rn(t, __fmul_rn(two_pi, rintf(__fdiv_rn(t, two_pi))));
}

__global__ void __launch_bounds__(NT) ray_expand_kernel(const Params p) {
  __shared__ float rs[8][RB];        // rays of the block, component-major
  __shared__ float zs[KB][RB];       // z of the block, sample-major
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RB, k0 = blockIdx.y * KB;
  const int kb = min(KB, p.K - k0);
  // one read of the block's rays and z rows, consecutive threads on
  // consecutive addresses
  for (int i = tid; i < RB * 8; i += NT)
    rs[i % 8][i / 8] = p.rays[static_cast<long long>(r0) * 8 + i];
  for (int i = tid; i < RB * kb; i += NT) {
    const int r = i / kb, kk = i - r * kb;
    zs[kk][r] = p.z[static_cast<long long>(r0 + r) * p.K + k0 + kk];
  }
  __syncthreads();

  const int r = tid % RB, kk = tid / RB;
  if (kk >= kb) return;
  const long long plane = static_cast<long long>(p.K) * p.R;
  const long long out = static_cast<long long>(k0 + kk) * p.R + r0 + r;
  float o[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = rs[i][r];
    d[i] = rs[3 + i][r];
  }
  const Sample a = expand(p, o, d, zs[kk][r]);

#pragma unroll
  for (int c = 0; c < 8; ++c) p.w8[c * plane + out] = a.w8[c];
  p.flat[out] = a.flat;
  __nv_bfloat16* aux = p.aux + out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    aux[i * plane] = __float2bfloat16_rn(a.canon[i]);
    aux[(3 + i) * plane] = __float2bfloat16_rn(d[i]);
  }
  float fr = p.freq;
  for (int f = 0; f < p.num_freqs; ++f) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      aux[(6 + 3 * f + i) * plane] = __float2bfloat16_rn(wrap(__fmul_rn(a.canon[i], fr), p.two_pi));
    fr = __fmul_rn(fr, 2.f);                 // exact: a power of two
  }
}

}  // namespace

// rays (R, 8) f32, z (R, K) f32, both contiguous; outputs as above. R a
// multiple of 32. ints: R, K, D, H, W, num_freqs; floats: lo[3], ext[3],
// freq_factor, fp32(2 pi).
extern "C" int ray_expand_fwd(const void* rays, const void* z, void* aux, void* w8, void* flat,
                              int R, int K, int D, int H, int W, int num_freqs,
                              float lo0, float lo1, float lo2, float ext0, float ext1,
                              float ext2, float freq, float two_pi, void* stream) {
  if (R <= 0 || K <= 0 || R % RB || D <= 0 || H <= 0 || W <= 0 || num_freqs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.rays = static_cast<const float*>(rays);
  p.z = static_cast<const float*>(z);
  p.aux = static_cast<__nv_bfloat16*>(aux);
  p.w8 = static_cast<float*>(w8);
  p.flat = static_cast<int*>(flat);
  p.R = R; p.K = K; p.D = D; p.H = H; p.W = W; p.num_freqs = num_freqs;
  p.lo[0] = lo0; p.lo[1] = lo1; p.lo[2] = lo2;
  p.ext[0] = ext0; p.ext[1] = ext1; p.ext[2] = ext2;
  p.freq = freq; p.two_pi = two_pi;
  const dim3 grid(R / RB, (K + KB - 1) / KB);
  ray_expand_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

EXPORT_ERROR_STRING
