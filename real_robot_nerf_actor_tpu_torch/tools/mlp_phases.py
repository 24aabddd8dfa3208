"""Where the time of the wgmma W8A8 ResnetFC kernel goes, on a CUDA card.

    python -m real_robot_nerf_actor_tpu_torch.tools.mlp_phases [--rows 65536 4224]

Builds two copies of `csrc/resnetfc_int8.cu` beside the package's own build:
one with a clock64 stamp by thread 0 of one block (the middle one of the
grid) after every barrier of `resnetfc_wgmma`, one with its wgmma
instructions removed (the weight ring still streams, every other phase
runs). It then runs the configs/serve.yaml field's width (d_latent 64,
d_hidden 512, 5 blocks, combine 3; random weights from a seed) at each row
count, static and dynamic scales, and prints one JSON line each: the
kernel's median time (CUDA events), the time without its wgmma
instructions, the first (mma.sync) design's time, and that block's cycles
per phase summed over the five blocks, with the SM clock.

Last, the weight stream alone (`RING`, built into the stamped copy): by
the kernel's bulk copies and by 2-D tensor-map boxes, for 132, 66 and 33
blocks (one per SM) and ring depths of 1 to 12 slices, one JSON line each
with the cycles a block takes per 16 KB slice. Cycles that fall with depth
mean latency binds; cycles that stay put mean one SM's intake rate does;
cycles that fall with fewer blocks mean the L2 does.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf

KERNEL_START = "  // warpgroup wgi owns output columns [wgi HN, (wgi + 1) HN) of each product\n"
KERNEL_END = "bool shapes_ok(const Params& p) {\n  return (p.d_hidden == 256"
WGMMA = "hopper::wgmma_s8_ss<HN>(acc, da, db, k);"
ZERO_OUT = "  for (int i = tid; i < BM * 15; i += THREADS) {"
STAMP = """
__device__ long long g_stamp[64];
__device__ int g_stamp_block;
#define STAMP() do { if (threadIdx.x == 0 && blockIdx.x == g_stamp_block && stamp_i < 64) \\
  g_stamp[stamp_i] = clock64(); ++stamp_i; } while (0)
"""
READER = """
extern "C" int read_stamps(void* out, int block) {
  if (out == nullptr)
    return static_cast<int>(cudaMemcpyToSymbol(wg::g_stamp_block, &block, sizeof(int)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, wg::g_stamp, sizeof(wg::g_stamp)));
}
"""
# The kernel's weight stream alone: thread 0 of each block loads every
# (512 x 32) slice of the block matrices through `stages` ring stages, each
# refilled as soon as it lands, as the kernel does (`bulk`: one contiguous
# 16 KB copy a slice; the bytes are wq's, in another order than the
# kernel's ring_layout, as only the rate is measured) or with a 32-byte-
# swizzle tensor map of the (out, in) matrices, two boxes of 256 rows of 32
# bytes a slice. Every block holds 215 KB of shared memory, so one block
# runs per SM.
RING_STAGES_MAX = 13
RING = """
namespace {
namespace wg {
__device__ __forceinline__ void ring_load(const CUtensorMap* tm, const unsigned char* wq,
                                          unsigned char* buf, uint64_t* full, int stages,
                                          int r) {
  constexpr int KSTEPS = MAXH / KS;
  const int s = r % stages;
  hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
  if (wq != nullptr) {
    hopper::bulk_load(buf + s * STAGE_BYTES, wq + static_cast<size_t>(r) * STAGE_BYTES,
                      STAGE_BYTES, &full[s]);
    return;
  }
  for (int n0 = 0; n0 < MAXH; n0 += 256)
    hopper::tma_load_2d(buf + s * STAGE_BYTES + n0 * KS, tm, &full[s], (r % KSTEPS) * KS,
                        (r / KSTEPS) * MAXH + n0);
}

__global__ void __launch_bounds__(32, 1)
ring_only(const __grid_constant__ CUtensorMap tm, const unsigned char* wq, int total,
          int stages, long long* cycles) {
  extern __shared__ unsigned char ring_raw[];
  unsigned char* buf = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + stages * STAGE_BYTES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long t0 = clock64();
  for (int r = 0; r < stages && r < total; ++r) ring_load(&tm, wq, buf, full, stages, r);
  for (int r = 0; r < total; ++r) {
    hopper::mbar_wait(&full[r % stages], (r / stages) & 1);
    if (r + stages < total) ring_load(&tm, wq, buf, full, stages, r + stages);
  }
  cycles[blockIdx.x] = clock64() - t0;
}
}  // namespace wg
}  // namespace

extern "C" int ring_only_run(void* wq, int n_mats, int stages, int blocks, int bulk,
                             void* cycles) {
  constexpr int kSmem = STAGES_MAX * wg::STAGE_BYTES + 2048;
  if (stages < 1 || stages > STAGES_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(wg::ring_only,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm;
  const uint64_t dims[2] = {static_cast<uint64_t>(MAXH), static_cast<uint64_t>(n_mats) * MAXH};
  const uint64_t strides[1] = {static_cast<uint64_t>(MAXH)};
  const uint32_t box[2] = {static_cast<uint32_t>(wg::KS), 256u};
  const int r = encode_u8(&tm, wq, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
  if (r != 0) return r;
  wg::ring_only<<<blocks, 32, kSmem>>>(tm, bulk ? static_cast<const unsigned char*>(wq) : nullptr,
                                       n_mats * MAXH / wg::KS, stages,
                                       static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
""".replace("STAGES_MAX", str(RING_STAGES_MAX))


def stamped_source(src: str) -> str:
    """The kernel source with a stamp at its start, after each of its
    barriers and block products, before the head and at its end."""
    for anchor in (KERNEL_START, KERNEL_END, ZERO_OUT, "namespace wg {\n"):
        if anchor not in src:
            raise ValueError(f"csrc/resnetfc_int8.cu changed: {anchor.strip()!r} not found")
    a, b = src.index(KERNEL_START), src.index(KERNEL_END)
    body = src[a:b]
    body = body.replace(KERNEL_START, "  int stamp_i = 0;\n  STAMP();\n" + KERNEL_START)
    body = body.replace("__syncthreads();", "__syncthreads(); STAMP();")
    body = body.replace(", sc);\n", ", sc); STAMP();\n")
    body = body.replace("  // ---- head:", "  STAMP();\n  // ---- head:")
    body = body.replace(ZERO_OUT, "  STAMP();\n" + ZERO_OUT)
    src = src[:a] + body + src[b:]
    return src.replace("namespace wg {\n", "namespace wg {\n" + STAMP, 1) + READER


def phase_labels(n_blocks: int, combine_layer: int, dynamic: bool):
    """The phase that ends at each stamp after the first."""
    labels = ["zi", "aux_input", "first_layer"]
    for blk in range(n_blocks):
        labels += ["injection"] if blk < combine_layer else []
        labels += ["t", "product_t", "scales_wait", "epilogue_u"]
        labels += ["u_row_scales"] if dynamic else []
        labels += ["quantize_u", "product_u", "scales_wait", "epilogue_h"]
    return labels + ["hidden", "head"]


def _build_lib(src: str, out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    (out / "resnetfc_int8.cu").write_text(src)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    lib_path = out / "lib.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                        str(out / "resnetfc_int8.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _build._SIGNATURES["resnetfc_int8"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _inputs(rows: int, dev, seed: int = 0):
    from real_robot_nerf_actor_tpu_torch.models import ResnetFC
    net = ResnetFC(d_in=42, d_out=36, n_blocks=5, d_latent=64, d_hidden=512, combine_layer=3)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():   # weights std fan_in^-1/2, biases 0.1
        fan_in = v.shape[0] if k == "lin_out_kernel" else v.shape[-1]
        std = fan_in ** -0.5 if v.dim() == 2 else 0.1
        sd[k] = (torch.randn(v.shape, generator=g) * std).to(dev)
    packed = rf.pack_resnetfc_params(sd)
    zi = rf.pack_mlp_input(torch.randn((rows, 64), generator=g).to(dev),
                           (torch.rand((rows, 3), generator=g) * 1.2 - 0.1).to(dev),
                           torch.randn((rows, 3), generator=g).to(dev), 6, 1.5).contiguous()
    amax = rf.capture_act_amax(zi, rf.pack_resnetfc_params(sd, quantize=False))
    return packed, zi, [float(a) * 1.05 / 127 + 1e-8 for a in amax]


def ring_stream(lib: ctypes.CDLL, wq: torch.Tensor, card: str,
                stages=(1, 2, 3, 4, 6, 8, 12), blocks=(132, 66, 33)):
    """The weight ring alone (RING) over the block matrices wq (2 nb, 512,
    512) int8: per copy ("bulk_1d" as the kernel, "tma_2d" boxes), block
    count and ring depth, one JSON line with the median time of a call, the mean
    cycles a block takes per slice, the bytes an SM takes in per cycle and
    the L2 read rate of the whole card."""
    lib.ring_only_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ring_only_run.restype = ctypes.c_int
    n_mats, dh = wq.shape[0], wq.shape[1]
    slices = n_mats * dh // 32
    for bulk, copy in ((0, "tma_2d"), (1, "bulk_1d")):
        for nb in blocks:
            cycles = torch.zeros(nb, dtype=torch.int64, device=wq.device)
            for depth in stages:
                def run(depth=depth, nb=nb, cycles=cycles, bulk=bulk):
                    _build.check(lib, lib.ring_only_run(wq.data_ptr(), n_mats, depth, nb, bulk,
                                                        cycles.data_ptr()), "ring_only")
                ms = _median_ms(run)
                per_slice = cycles.double().mean().item() / slices
                print(json.dumps({
                    "copy": copy, "ring_stages": depth, "blocks": nb, "ms": ms,
                    "cycles_per_slice": per_slice,
                    "bytes_per_cycle_per_sm": dh * 32 / per_slice,
                    "l2_read_gb_per_s": nb * wq.numel() / ms / 1e6, "card": card}),
                      flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[65536, 32768, 4224])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    src = (_build.CSRC / "resnetfc_int8.cu").read_text()
    if WGMMA not in src:
        raise ValueError("csrc/resnetfc_int8.cu changed: the wgmma call was not found")
    with tempfile.TemporaryDirectory() as tmp:
        stamped = _build_lib(stamped_source(src) + RING, Path(tmp) / "stamped")
        stamped.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        stamped.read_stamps.restype = ctypes.c_int
        no_wgmma = _build_lib(src.replace(WGMMA, ""), Path(tmp) / "no_wgmma")
        base = _build.load("resnetfc_int8")
        try:
            for rows in args.rows:
                packed, zi, static = _inputs(rows, dev)
                block = (rows + 63) // 64 // 2
                for mode, scales in (("static", static), ("dynamic", None)):
                    def run(lib, design=None):
                        _build._LOADED["resnetfc_int8"] = lib
                        return rf.fused_resnetfc_int8(zi, packed, act_scales=scales,
                                                      design=design)
                    ms = _median_ms(lambda: run(base))
                    ms_mma_sync = _median_ms(lambda: run(base, "mma_sync"))
                    ms_no_wgmma = _median_ms(lambda: run(no_wgmma))
                    stamped.read_stamps(None, block)
                    run(stamped)
                    torch.cuda.synchronize()
                    stamps = np.zeros(64, np.int64)
                    if stamped.read_stamps(stamps.ctypes.data, 0) != 0:
                        raise RuntimeError("could not read the stamps")
                    labels = phase_labels(5, 3, scales is None)
                    cycles = np.diff(stamps[:len(labels) + 1])
                    phases = {}
                    for label, c in zip(labels, cycles.tolist()):
                        phases[label] = phases.get(label, 0) + c
                    print(json.dumps({
                        "rows": rows, "scales": mode, "ms": ms, "ms_no_wgmma": ms_no_wgmma,
                        "ms_mma_sync": ms_mma_sync, "block": block,
                        "block_cycles": int(stamps[len(labels)] - stamps[0]),
                        "phase_cycles": phases, "card": card.strip()}), flush=True)
            ring_stream(stamped, packed["kernel"]["wq"], card.strip())
        finally:
            _build._LOADED["resnetfc_int8"] = base


if __name__ == "__main__":
    main()
