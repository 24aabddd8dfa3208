// Weight gradient of a 3-D convolution over NDHWC tensors, fp32 or float64.
//
// Replaces no TPU kernel: the JAX package leaves the policy UNet's backward
// (`models/blocks.py`, `MultiLayer3DEncoderShallow` and `MultiLayer3DEncoder`)
// to XLA. It was added because cuDNN computes these fp32 weight gradients with
// a grouped direct kernel that does not spread a reduction over 10^6 voxels
// at 8-64 channels across the card's SMs (about 44 ms of a joint train step
// on an H100, 180x the bound below). For S (N, Dp, Hp, Wp, A), L (N, Dl, Hl,
// Wl, B) and taps t = (tz, ty, tx) of a k^3 kernel,
//
//   dW[a, b, t] = sum_p S[p, a] * L[stride * p + t - pad, b]
//
// with L zero outside its volume, in torch's weight layout (A, B, k, k, k).
// A conv (stride s, padding pad) takes S = its output gradient, L = its
// input; the VALID transposed conv of stride 2 takes S = its input, L = the
// gradient of its whole (2n+1)^3 output, pad = 0.
//
// What bounds it on this card: 2 A B k^3 flops a position of S against
// (A + B) elements read: fp32 FMA, 67 TF/s (float64: 34 TF/s), for every
// shape of the two UNets; the bytes (3.35 TB/s) bound only the 1x1 head.
//
// Design: an implicit GEMM split over positions, the products in FFMA (no
// tensor cores, no TF32). A block owns a tile of dW: every tap, `ta`
// channels of A and `tb` of B (blockIdx.y). Its threads each own 8 x 4 of
// the tile at one tap (a "slot") and `groups` threads share a slot, each
// taking every groups-th position. Persistent blocks (blockIdx.x) walk
// bricks of S positions (x fastest), each staged with the halo of L it
// reads in shared memory by cp.async with zero fill (the halo's extent is
// stride * (brick - 1) + k a side), double-buffered: the next brick's
// copies fly while the threads multiply the current one. A table of the
// brick's positions in the volume gives each position's offsets in both
// stages, so edge bricks do no work for positions outside it. Per position
// a thread reads 8 values of S and 4 of L (16-byte loads) for 32 FMAs.
// At the end the groups of a slot are summed in shared memory in group
// order and each block writes its tile to its own row of the partials;
// `wgrad_fold` then sums the rows in row order. No atomics: two calls with
// the same shapes on the same card are bit-equal.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kFloat64 = 2;   // dtype tag of float64 (0 is fp32, common.cuh)
constexpr int NT_MAX = 256;   // threads a block at most
constexpr int RA = 8, RB = 4; // a thread's tile: channels of A by channels of B
constexpr int RED = RA * RB + 1;   // stride of a thread's row in the final sum

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift (Granlund
// and Montgomery's round-up method; the host makes m and s)
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

FastDiv make_fastdiv(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

struct Params {
  const void* s;        // S (N, Dp, Hp, Wp, A)
  const void* l;        // L (N, Dl, Hl, Wl, B)
  void* part;           // partials (gridDim.x, A, B, k^3)
  int dp, hp, wp, A;
  int dl, hl, wl, B;
  int k, stride, pad;
  int bz, by, bx;       // a brick of S positions
  int hz, hy, hx;       // its halo of L
  int ta, tb;           // channels of a tile (multiples of RA, RB)
  int nbz, nby, nbx, bricks;
  int slots, groups, tiles_b;
  int stage_bytes;      // one stage: S brick, L halo, position table
  FastDiv vs, vl;       // vectors a position in a stage: ta / VEC, tb / VEC
  FastDiv fbx, fby, fhx, fhy;
};

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N values from shared memory in 16-byte loads (p 16-byte aligned)
template <typename T, int N>
__device__ __forceinline__ void lds(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 t = *reinterpret_cast<const double2*>(p + i);
      v[i] = t.x; v[i + 1] = t.y;
    }
  }
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

struct Brick {
  int n, oz, oy, ox;    // batch and origin in S
  int ez, ey, ex;       // positions inside the volume a side
};

__device__ __forceinline__ Brick brick_at(const Params& p, int i) {
  Brick b;
  const int ix = i % p.nbx;
  i /= p.nbx;
  const int iy = i % p.nby;
  i /= p.nby;
  const int iz = i % p.nbz;
  b.n = i / p.nbz;
  b.oz = iz * p.bz; b.oy = iy * p.by; b.ox = ix * p.bx;
  b.ez = min(p.bz, p.dp - b.oz); b.ey = min(p.by, p.hp - b.oy); b.ex = min(p.bx, p.wp - b.ox);
  return b;
}

// Start the copies of brick `br` into stage `st` and write its position
// table: entry i (x fastest over the brick's part inside the volume) holds
// the element offsets of that position in the S stage and in the L halo.
template <typename T, int VEC>
__device__ __forceinline__ void stage_brick(const Params& p, unsigned char* st, const Brick& br,
                                            int a0, int b0) {
  const T* S = static_cast<const T*>(p.s);
  const T* L = static_cast<const T*>(p.l);
  const int npos = p.bz * p.by * p.bx;
  const int hpos = p.hz * p.hy * p.hx;
  T* sS = reinterpret_cast<T*>(st);
  T* sL = sS + npos * p.ta;
  int2* tab = reinterpret_cast<int2*>(sL + hpos * p.tb);
  constexpr int BYTES = VEC * sizeof(T);
  const int nvs = npos * static_cast<int>(p.vs.d);
  for (int e = threadIdx.x; e < nvs; e += blockDim.x) {
    const unsigned pos = p.vs.div(e);
    const int c = (e - pos * p.vs.d) * VEC;
    const unsigned zy = p.fbx.div(pos);
    const int x = pos - zy * p.bx;
    const unsigned z = p.fby.div(zy);
    const int y = zy - z * p.by;
    const int gz = br.oz + z, gy = br.oy + y, gx = br.ox + x, ga = a0 + c;
    const bool ok = gz < p.dp && gy < p.hp && gx < p.wp && ga < p.A;
    const T* src = ok ? S + (((static_cast<size_t>(br.n) * p.dp + gz) * p.hp + gy) * p.wp + gx)
                                * p.A + ga
                      : S;
    cp_async_zfill<BYTES>(sS + pos * p.ta + c, src, ok);
  }
  const int nvl = hpos * static_cast<int>(p.vl.d);
  const int lz = br.oz * p.stride - p.pad, ly = br.oy * p.stride - p.pad,
            lx = br.ox * p.stride - p.pad;
  for (int e = threadIdx.x; e < nvl; e += blockDim.x) {
    const unsigned pos = p.vl.div(e);
    const int c = (e - pos * p.vl.d) * VEC;
    const unsigned zy = p.fhx.div(pos);
    const int x = pos - zy * p.hx;
    const unsigned z = p.fhy.div(zy);
    const int y = zy - z * p.hy;
    const int gz = lz + static_cast<int>(z), gy = ly + y, gx = lx + x, gb = b0 + c;
    const bool ok = gz >= 0 && gz < p.dl && gy >= 0 && gy < p.hl && gx >= 0 && gx < p.wl &&
                    gb < p.B;
    const T* src = ok ? L + (((static_cast<size_t>(br.n) * p.dl + gz) * p.hl + gy) * p.wl + gx)
                                * p.B + gb
                      : L;
    cp_async_zfill<BYTES>(sL + pos * p.tb + c, src, ok);
  }
  const int nv = br.ez * br.ey * br.ex;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int x = i % br.ex, zy = i / br.ex, y = zy % br.ey, z = zy / br.ey;
    tab[i] = make_int2(((z * p.by + y) * p.bx + x) * p.ta,
                       ((z * p.hy + y) * p.hx + x) * p.stride * p.tb);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT_MAX, 2) wgrad_bricks(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tile_a = blockIdx.y / p.tiles_b, tile_b = blockIdx.y - tile_a * p.tiles_b;
  const int a0 = tile_a * p.ta, b0 = tile_b * p.tb;
  const int npos = p.bz * p.by * p.bx;
  const int hpos = p.hz * p.hy * p.hx;

  // this thread's slot: one tap, RA channels of A, RB channels of B
  const bool busy = tid < p.slots * p.groups;
  const int slot = tid % p.slots, g = tid / p.slots;
  const int nb = p.tb / RB, na = p.ta / RA;
  const int ib = slot % nb, ia = (slot / nb) % na, tap = slot / (nb * na);
  const int kk = p.k * p.k;
  const int tz = tap / kk, ty = (tap - tz * kk) / p.k, tx = tap % p.k;
  const int soff = ia * RA;
  const int loff = ((tz * p.hy + ty) * p.hx + tx) * p.tb + ib * RB;

  T acc[RA][RB];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[r][c] = T(0);

  int i = blockIdx.x;
  Brick br = brick_at(p, i);
  stage_brick<T, VEC>(p, smem, br, a0, b0);
  cp_async_commit();
  for (int it = 0; i < p.bricks; ++it, i += gridDim.x) {
    const int next = i + gridDim.x;
    const Brick cur = br;
    if (next < p.bricks) {
      br = brick_at(p, next);
      stage_brick<T, VEC>(p, smem + ((it + 1) & 1) * p.stage_bytes, br, a0, b0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (busy) {
      const T* sS = reinterpret_cast<const T*>(smem + (it & 1) * p.stage_bytes);
      const T* sL = sS + npos * p.ta;
      const int2* tab = reinterpret_cast<const int2*>(sL + hpos * p.tb);
      const int nv = cur.ez * cur.ey * cur.ex;
#pragma unroll 2
      for (int v = g; v < nv; v += p.groups) {
        const int2 o = tab[v];
        T sv[RA], lv[RB];
        lds(sS + o.x + soff, sv);
        lds(sL + o.y + loff, lv);
#pragma unroll
        for (int r = 0; r < RA; ++r)
#pragma unroll
          for (int c = 0; c < RB; ++c) acc[r][c] = fma_rn(sv[r], lv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

  // the groups of a slot summed in group order, then this block's row
  T* red = reinterpret_cast<T*>(smem);
  if (busy && g > 0) {
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int c = 0; c < RB; ++c) red[tid * RED + r * RB + c] = acc[r][c];
  }
  __syncthreads();
  if (!busy || g > 0) return;
  for (int h = 1; h < p.groups; ++h) {
    const T* o = red + (h * p.slots + slot) * RED;
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int c = 0; c < RB; ++c) acc[r][c] += o[r * RB + c];
  }
  const int taps = kk * p.k;
  T* part = static_cast<T*>(p.part) + static_cast<size_t>(blockIdx.x) * p.A * p.B * taps;
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int a = a0 + soff + r;
#pragma unroll
    for (int c = 0; c < RB; ++c) {
      const int b = b0 + ib * RB + c;
      if (a < p.A && b < p.B) part[(static_cast<size_t>(a) * p.B + b) * taps + tap] = acc[r][c];
    }
  }
}

// out[e] = sum over the partials' rows k of part[k, e], in row order
template <typename T>
__global__ void __launch_bounds__(256) wgrad_fold(const T* __restrict__ part, T* __restrict__ out,
                                                  long long E, int rows) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= E) return;
  T s = part[e];
  for (int k = 1; k < rows; ++k) s += part[k * E + e];
  out[e] = s;
}

// The launch's geometry; 0, or an error code for a shape it does not take.
int geometry(Params& p, int n, int dp, int hp, int wp, int A, int dl, int hl, int wl, int B,
             int k, int stride, int pad, int bz, int by, int bx, int ta, int tb, int groups,
             int dtype, int vec) {
  const int size = dtype == kFloat32 ? 4 : dtype == kFloat64 ? 8 : 0;
  if (size == 0 || !(vec == 1 || vec == 2 || (vec == 4 && size == 4))) return 1;
  if (n <= 0 || dp <= 0 || hp <= 0 || wp <= 0 || A <= 0 || dl <= 0 || hl <= 0 || wl <= 0 ||
      B <= 0 || k <= 0 || stride <= 0 || pad < 0 || bz <= 0 || by <= 0 || bx <= 0 || groups <= 0)
    return 1;
  if (ta <= 0 || tb <= 0 || ta % RA || tb % RB || A % vec || B % vec) return 1;
  p.dp = dp; p.hp = hp; p.wp = wp; p.A = A;
  p.dl = dl; p.hl = hl; p.wl = wl; p.B = B;
  p.k = k; p.stride = stride; p.pad = pad;
  p.bz = bz; p.by = by; p.bx = bx;
  p.hz = stride * (bz - 1) + k; p.hy = stride * (by - 1) + k; p.hx = stride * (bx - 1) + k;
  p.ta = ta; p.tb = tb;
  p.nbz = (dp + bz - 1) / bz; p.nby = (hp + by - 1) / by; p.nbx = (wp + bx - 1) / bx;
  const long long bricks = static_cast<long long>(n) * p.nbz * p.nby * p.nbx;
  p.slots = k * k * k * (ta / RA) * (tb / RB);
  p.groups = groups;
  p.tiles_b = (B + tb - 1) / tb;
  if (bricks >= (1ll << 31) || p.slots * groups > NT_MAX) return 1;
  p.bricks = static_cast<int>(bricks);
  const long long npos = static_cast<long long>(bz) * by * bx;
  const long long hpos = static_cast<long long>(p.hz) * p.hy * p.hx;
  const long long stage = ((npos * ta + hpos * tb) * size + npos * 8 + 15) / 16 * 16;
  if (stage * 2 > 227 * 1024 || npos * ta >= (1ll << 31) || hpos * tb >= (1ll << 31)) return 1;
  p.stage_bytes = static_cast<int>(stage);
  p.vs = make_fastdiv(ta / vec); p.vl = make_fastdiv(tb / vec);
  p.fbx = make_fastdiv(bx); p.fby = make_fastdiv(by);
  p.fhx = make_fastdiv(p.hx); p.fhy = make_fastdiv(p.hy);
  return 0;
}

int smem_bytes(const Params& p, int size) {
  const int red = p.slots * p.groups * RED * size;
  return red > 2 * p.stage_bytes ? red : 2 * p.stage_bytes;
}

// Lift the kernel's dynamic shared memory limit to the device's opt-in
// maximum, once a device: a cudaFuncSetAttribute on every launch costs the
// host far more than the launch where the queue is busy.
template <typename T, int VEC>
int allow_smem(int smem) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem <= 48 * 1024 || (dev < 64 && allowed[dev] >= smem)) return 0;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > most) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(wgrad_bricks<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) allowed[dev] = most;
  return 0;
}

template <typename T, int VEC>
int launch(const Params& p, int grid_x, void* out, cudaStream_t s) {
  const int smem = smem_bytes(p, sizeof(T));
  if (const int err = allow_smem<T, VEC>(smem)) return err;
  const dim3 grid(grid_x, ((p.A + p.ta - 1) / p.ta) * p.tiles_b);
  wgrad_bricks<T, VEC><<<grid, p.slots * p.groups, smem, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long E = static_cast<long long>(p.A) * p.B * p.k * p.k * p.k;
  wgrad_fold<T><<<static_cast<unsigned>((E + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(p.part), static_cast<T*>(out), E, grid_x);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int occupancy(const Params& p, int* blocks) {
  const int smem = smem_bytes(p, sizeof(T));
  if (const int err = allow_smem<T, VEC>(smem)) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wgrad_bricks<T, VEC>, p.slots * p.groups, smem));
}

}  // namespace

// Blocks of the brick kernel one SM holds at once for this geometry (into
// *blocks); the error code.
extern "C" int conv3d_wgrad_occupancy(int k, int stride, int bz, int by, int bx, int ta, int tb,
                                      int groups, int dtype, int vec, int* blocks) {
  Params p{};
  if (geometry(p, 1, bz, by, bx, ta, 1, 1, 1, tb, k, stride, 0, bz, by, bx, ta, tb, groups,
               dtype, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    if (vec == 4) return occupancy<float, 4>(p, blocks);
    if (vec == 2) return occupancy<float, 2>(p, blocks);
    return occupancy<float, 1>(p, blocks);
  }
  if (vec == 2) return occupancy<double, 2>(p, blocks);
  return occupancy<double, 1>(p, blocks);
}

// s (n, dp, hp, wp, A), l (n, dl, hl, wl, B) contiguous, of `dtype` (0 fp32,
// 2 float64), their bases aligned to vec elements; part (grid_x, A, B, k^3)
// and out (A, B, k, k, k) of the same dtype. Two launches on `stream`.
extern "C" int conv3d_wgrad_fwd(const void* s, const void* l, void* part, void* out, int n,
                                int dp, int hp, int wp, int A, int dl, int hl, int wl, int B,
                                int k, int stride, int pad, int bz, int by, int bx, int ta,
                                int tb, int groups, int grid_x, int dtype, int vec,
                                void* stream) {
  Params p{};
  if (geometry(p, n, dp, hp, wp, A, dl, hl, wl, B, k, stride, pad, bz, by, bx, ta, tb, groups,
               dtype, vec) ||
      grid_x <= 0 || grid_x > p.bricks)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t align = static_cast<size_t>(vec) * (dtype == kFloat32 ? 4 : 8);
  if (reinterpret_cast<uintptr_t>(s) % align || reinterpret_cast<uintptr_t>(l) % align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  p.s = s; p.l = l; p.part = part;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (vec == 4) return launch<float, 4>(p, grid_x, out, st);
    if (vec == 2) return launch<float, 2>(p, grid_x, out, st);
    return launch<float, 1>(p, grid_x, out, st);
  }
  if (vec == 2) return launch<double, 2>(p, grid_x, out, st);
  return launch<double, 1>(p, grid_x, out, st);
}

EXPORT_ERROR_STRING
