"""Where the time of the spatial_stats_3d kernel goes, on a CUDA card.

    python -m real_robot_nerf_actor_tpu_torch.tools.stats_ring

Builds copies of `csrc/spatial_stats.cu` beside the package's own build,
each with other ring constants (threads a block, stages, bytes a stage,
blocks an SM), and each also with the arithmetic left out ("ring only":
the stages still stream into shared memory and into the threads'
registers, and are freed and refilled as in the kernel; only the max, the
rescale and the terms are skipped), one without the folds of the slabs'
partials (its output is wrong), and one that reports the cycles of the
last block's tail: its group ticket, its group's fold, the final ticket and
the final fold (written over the output).
A torch.amax over each volume, one read of it, is timed first as the
card's yardstick for a read. It then times every copy on the act
step's three volumes (d0 100^3 x 64 fp32, u 100^3 x 64 bf16, dec 20^3 x 128
fp32; inputs of scale 0.3 from a seed) with the L2 evicted before each
call (a read of 512 MB), as device time from torch.profiler, and prints one
JSON line each with the card's name and power limit. A ring-only time near
the kernel's means the copies bind; one far below it means the arithmetic
does.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import tempfile
from pathlib import Path

import torch

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.ops import stats_cuda as sc

NO_FOLD = ("  if (!last_of(p.tickets + b * p.n_groups + g, in_group * gridDim.y, &is_last)) "
           "return;\n", "  return;  // no fold\n")
# cycles of the last block's tail (clock64 of its thread 0), written over
# out[0:4]: its ticket of the group, its group's fold, the final ticket, the
# final fold
TAIL = """  if (!last_of(p.tickets + b * p.n_groups + g, in_group * gridDim.y, &is_last)) return;
  const size_t src = (static_cast<size_t>(b) * p.slabs + g0) * p.C;
  const size_t dst = (static_cast<size_t>(b) * p.n_groups + g) * p.C;
  fold_range<true>(p.pm + src, p.ps + src, in_group, p.C, 1, p.gm + dst, p.gs + dst, p.k);
  if (!last_of(p.tickets + p.B * p.n_groups, p.B * p.n_groups, &is_last)) return;
  fold_range<true>(p.gm, p.gs, p.n_groups, p.C, p.B, nullptr,
                   reinterpret_cast<float4*>(p.out), p.k);
"""
TAIL_CLOCK = """  long long tc[5];
  tc[0] = clock64();
  if (!last_of(p.tickets + b * p.n_groups + g, in_group * gridDim.y, &is_last)) return;
  tc[1] = clock64();
  const size_t src = (static_cast<size_t>(b) * p.slabs + g0) * p.C;
  const size_t dst = (static_cast<size_t>(b) * p.n_groups + g) * p.C;
  fold_range<true>(p.pm + src, p.ps + src, in_group, p.C, 1, p.gm + dst, p.gs + dst, p.k);
  tc[2] = clock64();
  if (!last_of(p.tickets + p.B * p.n_groups, p.B * p.n_groups, &is_last)) return;
  tc[3] = clock64();
  fold_range<true>(p.gm, p.gs, p.n_groups, p.C, p.B, nullptr,
                   reinterpret_cast<float4*>(p.out), p.k);
  __syncthreads();
  tc[4] = clock64();
  if (t == 0)
    for (int i = 0; i < 4; ++i) p.out[i] = static_cast<float>(tc[i + 1] - tc[i]);
"""
CONSTANTS = ("constexpr int NT = 512;", "constexpr int STAGES = 3;",
             "constexpr int STAGE_BYTES = 32768;", "__launch_bounds__(NT, 2)")
ARITHMETIC = "    if (!active) continue;\n"
RING_ONLY = """    if (!active) continue;
    {  // ring only: keep the loads, skip the arithmetic
      float v[N];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        R::unpack(raw[j], v);
        s0[0] += v[0];
      }
      continue;
    }
"""
# (threads, stages, stage bytes, blocks an SM)
GEOMETRIES = [(512, 3, 32768, 2), (512, 4, 24576, 2), (256, 4, 16384, 3),
              (256, 3, 16384, 4), (1024, 3, 65536, 1)]


def variant_source(threads, stages, stage_bytes, blocks, mode):
    """The source with other constants; mode "ring only" skips the
    arithmetic, "no fold" the last block's fold (its output is wrong)."""
    src = (_build.CSRC / "spatial_stats.cu").read_text()
    for old in CONSTANTS + (ARITHMETIC, NO_FOLD[0], TAIL):
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/spatial_stats.cu changed: {old!r} not found once")
    src = (src.replace(CONSTANTS[0], f"constexpr int NT = {threads};")
           .replace(CONSTANTS[1], f"constexpr int STAGES = {stages};")
           .replace(CONSTANTS[2], f"constexpr int STAGE_BYTES = {stage_bytes};")
           .replace(CONSTANTS[3], f"__launch_bounds__(NT, {blocks})"))
    if mode == "ring only":
        src = src.replace(ARITHMETIC, RING_ONLY)
    if mode == "no fold":
        src = src.replace(*NO_FOLD)
    if mode == "tail clock":
        src = src.replace(TAIL, TAIL_CLOCK)
    return src


def build(variants, out_dir: Path):
    """One nvcc per variant, all at once; the loaded libraries."""
    nvcc = _build.find_nvcc()
    jobs = []
    for i, v in enumerate(variants):
        cu = out_dir / f"stats_{i}.cu"
        cu.write_text(variant_source(*v))
        so = out_dir / f"libstats_{i}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                     so))
    libs = []
    for proc, so in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log.decode(errors="replace"))
        lib = ctypes.CDLL(str(so))
        fn = lib.spatial_stats_3d_fwd
        fn.argtypes = _build._SIGNATURES["spatial_stats"]["spatial_stats_3d_fwd"]
        fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    return libs


def device_ms(run, flush, reps=20):
    """Device time of `run` a call, the flush's own events left out."""
    from torch.profiler import ProfilerActivity, profile

    def keys(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0}

    run()
    torch.cuda.synchronize()
    skip = set(keys(flush))

    def loop():
        for _ in range(reps):
            flush()
            run()

    return sum(t for k, t in keys(loop).items() if k not in skip) / reps / 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("stats_ring needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = [g + (mode,) for g in GEOMETRIES for mode in ("kernel", "ring only")]
    variants += [GEOMETRIES[0] + ("no fold",), GEOMETRIES[0] + ("tail clock",)]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp))
        gen = torch.Generator(device=dev).manual_seed(0)
        evict = torch.zeros(2 ** 27, dtype=torch.float32, device=dev)
        vols = {name: (torch.randn(1, v, v, v, c, generator=gen, device=dev) * 0.3).to(dt)
                for name, v, c, dt in (("d0", 100, 64, torch.float32),
                                       ("u", 100, 64, torch.bfloat16),
                                       ("dec", 20, 128, torch.float32))}
        tickets = torch.zeros(1024, dtype=torch.int32, device=dev)
        def flush():   # reads: the L2 is left holding clean lines of `evict`
            evict.sum()

        yardstick = {name: device_ms(lambda: torch.amax(x), flush) for name, x in vols.items()}
        print(json.dumps({"torch.amax (one read of the volume)": yardstick,
                          "card": card}), flush=True)
        for (threads, stages, stage_bytes, blocks, mode), lib in zip(variants, libs):
            times = {}
            for name, x in vols.items():
                b, v, _, _, c = x.shape
                pl = sc.plan(tuple(x.shape), x.element_size(), 0, sms, threads, stages,
                             stage_bytes, blocks)
                out = torch.empty((b, c, 4), device=dev)
                scratch = torch.empty(5 * b * c * (pl.slabs + pl.fold_groups), device=dev)

                def run():
                    code = lib.spatial_stats_3d_fwd(
                        x.data_ptr(), scratch.data_ptr(), out.data_ptr(), tickets.data_ptr(),
                        b, v, c, sc._DTYPES[x.dtype], int(pl.bulk), pl.rows_per_slab,
                        pl.slabs, pl.groups, sc.FOLD_GROUP, math.log2(math.e) / 0.01,
                        2.0 / (v - 1),
                        torch.cuda.current_stream().cuda_stream)
                    _build.check(lib, code, "spatial_stats_3d variant")

                times[name] = device_ms(run, flush)
                if mode == "tail clock":
                    times[name + "_tail_cycles"] = out.view(-1)[:4].tolist()
                if mode == "kernel":
                    want = sc.spatial_stats_3d_plain(x)
                    err = ((out - want).abs() / want[..., :1]).max().item()
                    if not err <= 1e-5:
                        raise SystemExit(f"variant {threads}/{stages}/{stage_bytes}: "
                                         f"error {err} of the denominator on {name}")
            print(json.dumps({"threads": threads, "stages": stages,
                              "stage_bytes": stage_bytes, "blocks_per_sm": blocks,
                              "mode": mode, "cold_l2_device_ms": times,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
