// 3-D spatial-softmax statistics in one pass over the volume, for Hopper
// (sm_90a).
//
// Replaces: real_robot_nerf_actor_tpu/ops/stats_pallas.py spatial_stats_3d
// (the Pallas kernel _stats_kernel) -> spatial_stats_3d_fwd.
//
// For a cubic (B, V, V, V, C) fp32 or bf16 volume, rows n = (z V + y) V + x,
// and e = exp((x - max_c) / T) with the max over the channel's whole volume,
// it writes (B, C, 4) fp32 [sum e, sum e lin[y], sum e lin[z], sum e lin[x]],
// lin[i] = i * 2/(V-1) - 1 (the reference's meshgrid('xy') order).
//
// What bounds it on this card: every byte of the volume is read once and
// each element costs ~10 fp32 operations, so memory binds: 256 MB of the
// policy's fp32 100^3 x 64 d0 take 0.076 ms at 3.35 TB/s (H100 SXM).
//
// Design: one read of device memory and no pass before the kernel, so the
// per-channel max is found on the way (an online softmax):
// - the grid cuts each batch's rows into slabs of whole stages, two blocks
//   of 512 threads per SM (ops/stats_cuda.plan picks the sizes);
// - "bulk" route (a row of whole 16 bytes, C/4 <= 512, an aligned base): a
//   ring of 3 shared-memory stages of 32 KB, each whole rows, each filled by
//   one TMA bulk copy (cp.async.bulk) that completes on its mbarrier. A
//   thread owns 4 channels of a row and rows rp, rp + RP, ... of each stage
//   (RP = 512 / (C/4) rows side by side); it copies them to registers, and
//   each warp frees the stage on a second mbarrier, on which thread 0 waits
//   to refill it, so three stages stay in flight while the warps compute;
// - "plain" route (any other shape): the same loop over plain loads from
//   device memory, a thread owning one channel, 512 channels a block;
// - per stage a thread takes its channels' max over its rows, rescales its
//   running sums by exp2((m_old - m_new) k) where the max rose, then adds
//   exp2((x - m) k) times [1, lin[y], lin[z], lin[x]]; k = log2(e) / T;
// - at the slab's end the block merges its threads' (m, sums) per channel
//   through shared memory and writes one partial (m, sums) per (b, slab, c);
// - the last block to finish each group of 16 slabs (an atomic ticket,
//   which it resets to 0 for the next call) folds the group's partials, and
//   the last of those folds the groups' into (B, C, 4); every fold runs in a
//   fixed order, so a result is the same from run to run. (One fold of all
//   261 slabs of d0 by the last block took 15-25 us on an H100 80GB HBM3 at
//   700 W, tools/stats_ring.py; the two levels take ~7 us.)
// A channel that is -inf over a whole stage, thread or slab keeps m = -inf
// and adds 0: no (-inf) - (-inf) is ever formed.
#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>

namespace {

constexpr int NT = 512;              // threads of a block
constexpr int STAGES = 3;            // ring depth
constexpr int STAGE_BYTES = 32768;   // one stage: whole rows, at most this
constexpr int LIN_MAX = 1291;        // lin[] in shared memory: V^3 < 2^31 rows
constexpr int LIN_BYTES = (LIN_MAX * 4 + 15) / 16 * 16;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + LIN_BYTES + 2 * STAGES * 8;

// n / d for 0 <= n < 2^31 (round-up multiplier, as torch's IntDivider)
struct FastDiv {
  uint32_t d, magic, shift;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

struct Params {
  const void* x;
  float4* ps;         // (B, slabs, C) slab sums
  float* pm;          // (B, slabs, C) slab maxima
  float4* gs;         // (B, groups of slabs, C) sums of each group of slabs
  float* gm;          // (B, groups of slabs, C) their maxima
  float* out;         // (B, C, 4)
  unsigned* tickets;  // B * n_groups + 1 counters, 0 between calls
  int B, V, C, n_rows, rows_per_slab, slabs, fold_group, n_groups;
  float k, step;
  FastDiv fv;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// What a thread keeps of one row: Raw, the N channel values it owns as
// loaded (from the stage in shared memory, or from device memory on the
// plain route), `empty` for a row past the slab's end (-inf: no max, e = 0),
// `unpack` to fp32, and `rmax`, the channels' max of two rows.
template <typename T, bool BULK>
struct Rows;

template <>
struct Rows<float, true> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw empty() {
    return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
  __device__ __forceinline__ static Raw load(const float* src, int r, int lane, int C) {
    return *reinterpret_cast<const float4*>(src + r * C + lane * 4);
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[4]) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static Raw rmax(const Raw& a, const Raw& b) {
    return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
  }
};

template <>
struct Rows<__nv_bfloat16, true> {
  static constexpr int N = 4;
  using Raw = uint2;
  __device__ __forceinline__ static Raw empty() { return make_uint2(0xFF80FF80u, 0xFF80FF80u); }
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* src, int r, int lane, int C) {
    return *reinterpret_cast<const uint2*>(src + r * C + lane * 4);
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[4]) {
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  }
  // the max of two channel pairs at once, on the packed bf16 (exact)
  __device__ __forceinline__ static uint32_t hmax(uint32_t a, uint32_t b) {
    __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                               *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<uint32_t*>(&r);
  }
  __device__ __forceinline__ static Raw rmax(const Raw& a, const Raw& b) {
    return make_uint2(hmax(a.x, b.x), hmax(a.y, b.y));
  }
};

template <typename T>
struct Rows<T, false> {
  static constexpr int N = 1;
  using Raw = float;
  __device__ __forceinline__ static Raw empty() { return -INFINITY; }
  __device__ __forceinline__ static Raw load(const T* src, int r, int lane, int C) {
    if constexpr (sizeof(T) == 4) {
      return __ldg(reinterpret_cast<const float*>(src) + static_cast<size_t>(r) * C + lane);
    } else {
      const unsigned short u =
          __ldg(reinterpret_cast<const unsigned short*>(src) + static_cast<size_t>(r) * C + lane);
      return __uint_as_float(static_cast<uint32_t>(u) << 16);
    }
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[1]) { v[0] = q; }
  __device__ __forceinline__ static Raw rmax(const Raw& a, const Raw& b) { return fmaxf(a, b); }
};

// (M, S) <- the merge of (M, S) and (m2, s2): both rescaled to the larger
// max; two empty ones (-inf) stay empty
__device__ __forceinline__ void merge(float& M, float (&S)[4], float m2, const float4& s2,
                                      float k) {
  const float mn = fmaxf(M, m2);
  if (mn == -INFINITY) return;
  const float f1 = exp2f((M - mn) * k), f2 = exp2f((m2 - mn) * k);
  S[0] = __fadd_rn(__fmul_rn(S[0], f1), __fmul_rn(s2.x, f2));
  S[1] = __fadd_rn(__fmul_rn(S[1], f1), __fmul_rn(s2.y, f2));
  S[2] = __fadd_rn(__fmul_rn(S[2], f1), __fmul_rn(s2.z, f2));
  S[3] = __fadd_rn(__fmul_rn(S[3], f1), __fmul_rn(s2.w, f2));
  M = mn;
}

// A fold of partials (m, sums) into one per channel, in a fixed order.
// Entries [bb][i][c] for bb < nb, i < n, c < C (m as floats, sums as
// float4 at the same index) become out_s[bb][c] (and out_m[bb][c] unless it
// is null), all of the block's threads taking part. Each (bb, c) goes to
// `tpi` lanes of one warp; lane j merges entries j, j + tpi, ... in order,
// then the lanes merge in a fixed butterfly. A lane loads FOLD_BATCH
// entries at once, with no branch between the loads (an index past the end
// reads the last entry again, and is not merged), so a batch costs one
// round trip to L2. The partials in device memory are read through L2
// (GLOBAL), the block's own in shared memory directly.
constexpr int FOLD_BATCH = 8;

template <bool GLOBAL>
__device__ __forceinline__ float load_m(const float* p) {
  if constexpr (GLOBAL) return __ldcg(p); else return *p;
}
template <bool GLOBAL>
__device__ __forceinline__ float4 load_s(const float4* p) {
  if constexpr (GLOBAL) return __ldcg(p); else return *p;
}

template <bool GLOBAL>
__device__ void fold_range(const float* m, const float4* sums, int n, int C, int nb,
                           float* out_m, float4* out_s, float k) {
  const int items = nb * C;
  int tpi = 1;
  while (tpi < 32 && 2 * tpi * items <= NT) tpi *= 2;
  const int sub = threadIdx.x % tpi;
  const int step = FOLD_BATCH * tpi;
  for (int base = 0; base < items; base += NT / tpi) {
    const int item = base + threadIdx.x / tpi;
    const bool valid = item < items;
    const int first = valid ? (item / C) * n * C + item % C : 0;
    float M = -INFINITY, S[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = sub; valid && i0 < n; i0 += step) {
      float mb[FOLD_BATCH];
      float4 vb[FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u) {
        const int idx = first + min(i0 + u * tpi, n - 1) * C;
        mb[u] = load_m<GLOBAL>(m + idx);
        vb[u] = load_s<GLOBAL>(sums + idx);
      }
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        if (i0 + u * tpi < n) merge(M, S, mb[u], vb[u], k);
    }
    for (int d = 1; d < tpi; d <<= 1) {
      const float m2 = __shfl_xor_sync(0xFFFFFFFFu, M, d);
      float4 s2;
      s2.x = __shfl_xor_sync(0xFFFFFFFFu, S[0], d);
      s2.y = __shfl_xor_sync(0xFFFFFFFFu, S[1], d);
      s2.z = __shfl_xor_sync(0xFFFFFFFFu, S[2], d);
      s2.w = __shfl_xor_sync(0xFFFFFFFFu, S[3], d);
      merge(M, S, m2, s2, k);
    }
    if (valid && sub == 0) {
      out_s[item] = make_float4(S[0], S[1], S[2], S[3]);
      if (out_m != nullptr) out_m[item] = M;
    }
  }
}

// Whether this block is the last of `count` to arrive at `ticket` (which
// the last one resets to 0): after its writes, every block takes a ticket.
// The barrier orders the block's writes before thread 0's fence (fences are
// cumulative), and the fence after a last ticket orders the reads that the
// barrier lets follow it.
__device__ __forceinline__ bool last_of(unsigned* ticket, unsigned count, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(ticket, 1u) == count - 1;
    if (*flag) {
      *ticket = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  return *flag;
}

template <typename T, bool BULK>
__global__ void __launch_bounds__(NT, 2) stats_kernel(Params p) {
  using R = Rows<T, BULK>;
  constexpr int N = R::N;
  // rows of a stage per thread: 32 KB over 512 threads of N channels
  constexpr int RPT = STAGE_BYTES / (NT * N * static_cast<int>(sizeof(T)));
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;
  float* lin = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + LIN_BYTES);
  uint64_t* empty = full + STAGES;

  const int t = threadIdx.x;
  const int slab = blockIdx.x, b = blockIdx.z;
  const int c0 = blockIdx.y * NT * N;           // the block's first channel
  const int cg = min(p.C - c0, NT * N);          // its channels
  const int lanes = cg / N;                      // threads across a row
  const int rp_n = NT / lanes;                   // rows side by side
  const bool active = t < rp_n * lanes;
  const int lane = t % lanes, rp = t / lanes;
  const int row0 = slab * p.rows_per_slab;
  const int rows = min(p.rows_per_slab, p.n_rows - row0);
  const int stage_rows = rp_n * RPT;
  const int n_st = (rows + stage_rows - 1) / stage_rows;
  const uint32_t row_bytes = p.C * sizeof(T);
  const T* xb = static_cast<const T*>(p.x) + (static_cast<size_t>(b) * p.n_rows + row0) * p.C;

  auto issue = [&](int i) {
    const int s = i % STAGES;
    const uint32_t bytes = min(stage_rows, rows - i * stage_rows) * row_bytes;
    hopper::mbar_expect_tx(&full[s], bytes);
    hopper::bulk_load(smem + s * STAGE_BYTES,
                      reinterpret_cast<const unsigned char*>(xb) +
                          static_cast<size_t>(i) * stage_rows * row_bytes,
                      bytes, &full[s]);
  };
  if (BULK && t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NT / 32);
    }
    hopper::mbar_fence_init();
    for (int i = 0; i < STAGES && i < n_st; ++i) issue(i);
  }
  for (int i = t; i < p.V; i += NT)
    lin[i] = __fsub_rn(__fmul_rn(static_cast<float>(i), p.step), 1.0f);
  __syncthreads();

  float m[N], s0[N], sy[N], sz[N], sx[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    m[n] = -INFINITY;
    s0[n] = sy[n] = sz[n] = sx[n] = 0.f;
  }

  for (int i = 0; i < n_st; ++i) {
    const int rows_i = min(stage_rows, rows - i * stage_rows);
    // my rows of this stage, into registers
    typename R::Raw raw[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) raw[j] = R::empty();
    if constexpr (BULK) {
      const int s = i % STAGES;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      const T* src = reinterpret_cast<const T*>(smem + s * STAGE_BYTES);
      if (active) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          if (rp + j * rp_n < rows_i) raw[j] = R::load(src, rp + j * rp_n, lane, p.C);
      }
      // the stage is free once every warp has its rows: thread 0 refills it
      __syncwarp();
      if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
      if (t == 0 && i + STAGES < n_st) {
        hopper::mbar_wait(&empty[s], (i / STAGES) & 1);
        issue(i + STAGES);
      }
    } else if (active) {
      const T* src = xb + static_cast<size_t>(i) * stage_rows * p.C + c0;
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (rp + j * rp_n < rows_i) raw[j] = R::load(src, rp + j * rp_n, lane, p.C);
    }
    if (!active) continue;
    // 1. this stage's max of my channels; where it rose, rescale
    typename R::Raw rm = raw[0];
#pragma unroll
    for (int j = 1; j < RPT; ++j) rm = R::rmax(rm, raw[j]);
    float mx[N];
    R::unpack(rm, mx);
    float ms[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (mx[n] > m[n]) {
        const float f = exp2f((m[n] - mx[n]) * p.k);  // 0 while m is -inf
        s0[n] *= f; sy[n] *= f; sz[n] *= f; sx[n] *= f;
        m[n] = mx[n];
      }
      ms[n] = m[n] == -INFINITY ? 0.f : m[n];  // all -inf so far: e = 0
    }
    // 2. the terms; the position of each row once (rows past the end hold
    // -inf and add 0)
    const int row = row0 + i * stage_rows + rp;
    const uint32_t q = fdiv(static_cast<uint32_t>(row), p.fv);
    int x = row - q * p.V;
    int z = fdiv(q, p.fv);
    int y = q - z * p.V;
    // z reaches V only in rows past the volume's end (-inf, e = 0): a clamp
    // keeps their weights finite, as 0 * NaN would not be 0
    float ly = lin[y], lz = lin[min(z, p.V - 1)];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float v[N];
      R::unpack(raw[j], v);
      const float lx = lin[x];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float e = hopper::exp2_approx((v[n] - ms[n]) * p.k);
        s0[n] += e;
        sy[n] = fmaf(e, ly, sy[n]);
        sz[n] = fmaf(e, lz, sz[n]);
        sx[n] = fmaf(e, lx, sx[n]);
      }
      x += rp_n;  // the next row of this thread: y and z change at a wrap
      if (x >= p.V) {
        do {
          x -= p.V;
          if (++y == p.V) { y = 0; ++z; }
        } while (x >= p.V);
        ly = lin[y];
        lz = lin[min(z, p.V - 1)];
      }
    }
  }

  // the block's (m, sums) per channel, merged over its rows side by side
  __syncthreads();
  float4* sc_s = reinterpret_cast<float4*>(smem);  // [rp_n][cg]: the ring is free
  float* sc_m = reinterpret_cast<float*>(sc_s + rp_n * cg);
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int idx = rp * cg + lane * N + n;
      sc_m[idx] = m[n];
      sc_s[idx] = make_float4(s0[n], sy[n], sz[n], sx[n]);
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * p.slabs + slab) * p.C + c0;
  fold_range<false>(sc_m, sc_s, rp_n, cg, 1, p.pm + part, p.ps + part, p.k);

  // the last block of each group of slabs folds the group's partials, and
  // the last of those folds the groups'
  const int g = slab / p.fold_group;
  const int g0 = g * p.fold_group;
  const int in_group = min(p.fold_group, p.slabs - g0);
  if (!last_of(p.tickets + b * p.n_groups + g, in_group * gridDim.y, &is_last)) return;
  const size_t src = (static_cast<size_t>(b) * p.slabs + g0) * p.C;
  const size_t dst = (static_cast<size_t>(b) * p.n_groups + g) * p.C;
  fold_range<true>(p.pm + src, p.ps + src, in_group, p.C, 1, p.gm + dst, p.gs + dst, p.k);
  if (!last_of(p.tickets + p.B * p.n_groups, p.B * p.n_groups, &is_last)) return;
  fold_range<true>(p.gm, p.gs, p.n_groups, p.C, p.B, nullptr,
                   reinterpret_cast<float4*>(p.out), p.k);
}

template <typename T, bool BULK>
int launch(const Params& p, int groups, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(stats_kernel<T, BULK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.slabs, groups, p.B);
  stats_kernel<T, BULK><<<grid, NT, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, V, V, V, C) contiguous fp32 (dtype 0) or bf16 (1); scratch: float4
// sums (B, slabs, C) and (B, n_groups, C), then fp32 maxima of the same
// shapes, n_groups = ceil(slabs / fold_group); out (B, C, 4) fp32; tickets
// B * n_groups + 1 zeroed uint32 (left zero). bulk 1 takes the TMA ring
// (the caller has checked 16-byte rows, C/4 <= 512 and alignment), 0 plain
// loads with `groups` blocks of 512 channels. k = log2(e) / T, step =
// 2 / (V - 1).
extern "C" int spatial_stats_3d_fwd(const void* x, void* scratch, void* out, void* tickets,
                                    int B, int V, int C, int dtype, int bulk,
                                    int rows_per_slab, int slabs, int groups, int fold_group,
                                    float k, float step, void* stream) {
  if (B <= 0 || V <= 1 || C <= 0 || slabs <= 0 || groups <= 0 || fold_group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(V) * V * V;
  if (n_rows >= (1ll << 31) || (bulk && (C % 4 || C / 4 > NT)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  const int n_groups = (slabs + fold_group - 1) / fold_group;
  const size_t per_slab = static_cast<size_t>(B) * C;
  p.x = x;
  p.ps = static_cast<float4*>(scratch);
  p.gs = p.ps + per_slab * slabs;
  p.pm = reinterpret_cast<float*>(p.gs + per_slab * n_groups);
  p.gm = p.pm + per_slab * slabs;
  p.out = static_cast<float*>(out);
  p.tickets = static_cast<unsigned*>(tickets);
  p.B = B; p.V = V; p.C = C; p.n_rows = static_cast<int>(n_rows);
  p.rows_per_slab = rows_per_slab; p.slabs = slabs;
  p.fold_group = fold_group; p.n_groups = n_groups;
  p.k = k; p.step = step;
  p.fv = make_fastdiv(V);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return bulk ? launch<float, true>(p, groups, s) : launch<float, false>(p, groups, s);
  if (dtype == kBFloat16)
    return bulk ? launch<__nv_bfloat16, true>(p, groups, s)
                : launch<__nv_bfloat16, false>(p, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

EXPORT_ERROR_STRING
