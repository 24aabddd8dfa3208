"""Run one cell of the port's benchmark once and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (weights, inputs and kernels built from the seed; compiles
on a checkout's first run), measures a closed-loop window of `--seconds`
(with --trace 1 profiled windows of at most TRACE_SECONDS together, read
by the cell's per-layer metrics), then checks what the window produced
against the plain reference and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics, device
[, breakdown], checks.
Exits non-zero with no result line without enough CUDA devices, or when
JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TRACE_SECONDS = 8.0
DEVICE_SHARE = 0.625   # of the traced time: the CUDA-only window


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             root=None, start: float = START) -> dict:
    """One run of `workload` on `device` (the checkout at `root`, by default
    this one); returns the result without printing it."""
    import torch

    from h100_bench.core import manifest as mf
    from h100_bench.core.trace import read_profile
    from h100_bench.core.window import LayerContext, run_window, sync

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = mf.load_manifest(None if root is None else Path(root) / "BENCHMARK.json")
    spec = mf.cell_spec(manifest, workload, root)
    cell = mf.load_driver(spec["traffic"]["driver"], spec["bench"]).Cell(spec, seed, device)
    print(f"setup imports_and_context {time.perf_counter() - start:.3f}", file=sys.stderr)
    with torch.profiler.record_function("bench.setup"):
        cell.setup()
    sync(device)
    setup_s = time.perf_counter() - start
    gc.collect()
    gc.freeze()   # the set-up's objects: no collection walks them in the window

    out = {"metrics": {}}
    if trace:
        # two profiled windows: CUDA activity alone (the device's busy time,
        # the kernels, the rate: the host's profiling costs little there),
        # then CPU and CUDA (host ranges and what the host was doing in the
        # device's idle gaps; recording every host op slows the host)
        from torch.profiler import ProfilerActivity, profile
        on_cuda = torch.device(device).type == "cuda"
        acts = [ProfilerActivity.CUDA] if on_cuda else [ProfilerActivity.CPU]
        t = min(seconds, TRACE_SECONDS)
        with profile(activities=acts) as prof:
            record = run_window(cell.step, t * DEVICE_SHARE, device)
        tr = read_profile(prof, record.window_s)
        with profile(activities=acts + ([ProfilerActivity.CPU] if on_cuda else [])) as prof:
            host = run_window(cell.step, t * (1 - DEVICE_SHARE), device)
        hr = read_profile(prof, host.window_s)
        del prof
        ctx = LayerContext(tr, cell, record.index, hr, host.index)
        for m in spec["per_layer"]:
            v = mf.load_reader(m["name"], spec["bench"])(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": tr.breakdown()["device_ops"],
                            "idle_gaps": hr.breakdown()["idle_gaps"]}
        busy = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        record.work += host.work
    else:
        record = run_window(cell.step, seconds, device)
        e2e = dict(cell.end_to_end(record), setup_s=setup_s)
        for m in spec["end_to_end"]:
            out["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        busy = {}
    lat = sorted(record.latencies())
    print(f"window units {len(lat)} seconds {record.window_s:.3f} unit_s p10 "
          f"{lat[len(lat) // 10]:.4f} p50 {lat[len(lat) // 2]:.4f} p90 "
          f"{lat[len(lat) * 9 // 10]:.4f}", file=sys.stderr)
    attempted, failed = cell.attempted_failed(record)
    cell.window_closed()
    if torch.device(device).type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    dev.update(busy)
    cell.free()
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    result.update(out)
    result["device"] = dev
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    order = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    return {k: result[k] for k in order if k in result}


def main(argv=None) -> int:
    args = parse(argv)
    # one process with few threads: the host drives the card, and idle
    # worker threads spinning on the host's cores make runs spread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import torch

    torch.set_num_threads(1)

    from h100_bench.core import manifest as mf
    from h100_bench.core.guard import forbidden_modules

    spec = mf.cell_spec(mf.load_manifest(), args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the port's kernels build once into a fixed directory in the checkout
    # (its git-ignored .build/); nothing else is cached
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
