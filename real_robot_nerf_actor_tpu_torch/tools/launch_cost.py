"""Where the time of a serving-render kernel call goes, on a CUDA card.

    python -m real_robot_nerf_actor_tpu_torch.tools.launch_cost
    python -m real_robot_nerf_actor_tpu_torch.tools.launch_cost --against DIR

For `ray_expand` (4096 rays x 16 and x 8 samples) and `corner_lerp` (65536
and 32768 rows of 8 x 64 bf16), the shapes of the serving frame's coarse
and fine tiles, with inputs from a seed, it prints one JSON line per call:
  - host_us: the median host time of the wrapper call alone, without a
    synchronise (the queue drained before each call, outside the timing);
  - ms: the median of CUDA events around single calls, which is the host
    time wherever the host is slower than the card;
  - device_ms: the kernel's device time from torch.profiler; for
    corner_lerp also frame_device_ms, its time where each call follows a
    fresh row gather (rows_all[flat] over a 101^3 x 512 grid), as in the
    frame, so that it finds its rows where the gather left them in L2
    (a call that repeats on the same 33.5 MB of rows finds them all there).
The host and event times are taken before any profiler session, which
leaves later host calls some 20% slower on an H100 host. Then, for this
tree, one line of the host cost of each piece of the launch path: the
outputs (three allocations, or one and three views), the stream handle
(raw, and through a Stream object), the ctypes call itself (its entry
points refuse a zero size and return at once), the input checks and the
constant cache, and corner_lerp's launch with and without the
autograd.Function around it.

With --against DIR, a checkout of another commit (unpacked with `git
archive`, e.g. the parent's `real_robot_nerf_actor_tpu_torch/`), the same
calls are measured in subprocesses that import the package from DIR and
from this tree in turns: DIR, this tree, this tree, DIR; so two versions of
the wrappers compare on one card in one call. Each line carries the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
DIMS = (100, 100, 100)
ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def host_us(fn, reps=200):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def event_ms(fn, reps=50):
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


def device_ms(fn, reps=50, before=None, only=""):
    """Device ms of one call: the device time of the kernels whose name
    holds `only`, over `reps` calls, each after `before()` where given."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before:
                before()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if only in e.key)
    return total / reps / 1e3


def calls(dev):
    """(name, shape, call, frame order) for the frame's four calls, inputs
    from a seed; frame order: (a fresh row gather, the kernel's name) for
    corner_lerp."""
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    rng = np.random.default_rng(0)
    lo, hi = np.array(BOUNDS[:3]), np.array(BOUNDS[3:])
    out = []
    for k in (16, 8):
        o = rng.uniform(lo, hi, (4096, 3))
        d = rng.standard_normal((4096, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = torch.from_numpy(np.concatenate([o, d, np.zeros((4096, 2))], 1)
                                .astype(np.float32)).to(dev)
        z = torch.from_numpy(np.sort(rng.uniform(0, 0.6, (4096, k)), 1)
                             .astype(np.float32)).to(dev)
        out.append(("ray_expand", [4096, k],
                    lambda rays=rays, z=z: ray_expand(rays, z, DIMS, BOUNDS), None))
    n_grid = 101 ** 3
    g = torch.Generator(device=dev).manual_seed(1)
    rows_all = torch.randn((n_grid, 512), generator=g, device=dev).to(torch.bfloat16)
    for m in (65536, 32768):
        flat = torch.from_numpy(rng.integers(0, n_grid, m)).to(dev)
        rows = rows_all[flat]
        w = torch.from_numpy(rng.uniform(0, 1, (8, m)).astype(np.float32)).to(dev)

        def gather(rows=rows, flat=flat):
            torch.index_select(rows_all, 0, flat, out=rows)

        out.append(("corner_lerp", [m, 512], lambda rows=rows, w=w: corner_lerp(rows, w),
                    (gather, "lerp")))
    return out


def pieces(dev):
    """Host us of each piece of this tree's launch path."""
    from real_robot_nerf_actor_tpu_torch.ops import _build
    from real_robot_nerf_actor_tpu_torch.ops import lerp_cuda as lc
    from real_robot_nerf_actor_tpu_torch.ops import ray_expand_cuda as rx
    rays = torch.zeros((4096, 8), device=dev)
    z = torch.zeros((4096, 16), device=dev)
    rows = torch.zeros((4096, 512), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((8, 4096), device=dev)
    ints, floats = rx.launch_consts(DIMS, BOUNDS, 6, 1.5)
    lib_rx, lib_lc = _build.load("ray_expand"), _build.load("corner_lerp")

    def tight(fn, reps=2000):
        for _ in range(20):
            fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e6)
        return statistics.median(times)

    def three():
        return (torch.empty((24, 16, 4096), dtype=torch.bfloat16, device=dev),
                torch.empty((8, 16, 4096), device=dev),
                torch.empty((16, 4096), dtype=torch.int32, device=dev))

    def one():
        buf = torch.empty(84 * 16 * 4096, dtype=torch.uint8, device=dev)
        n_aux, n = 48 * 16 * 4096, 4 * 16 * 4096
        return (buf[:n_aux].view(torch.bfloat16).view(24, 16, 4096),
                buf[n_aux:n_aux + 8 * n].view(torch.float32).view(8, 16, 4096),
                buf[n_aux + 8 * n:].view(torch.int32).view(16, 4096))

    return {
        "outputs_three_allocations": tight(three, 500),
        "outputs_one_allocation": tight(one, 500),
        "raw_stream": tight(lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        "stream_object": tight(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "current_device": tight(torch.cuda.current_device),
        "ray_expand_ctypes_20_args": tight(lambda: lib_rx.ray_expand_fwd(
            0, 0, 0, 0, 0, 0, 16, *ints, *floats, 0)),
        "corner_lerp_ctypes_8_args": tight(lambda: lib_lc.corner_lerp_fwd(
            0, 0, 0, -1, 64, 1, 1, 0)),
        "ray_expand_check": tight(lambda: rx._check(rays, z)),
        "ray_expand_consts": tight(lambda: rx.launch_consts(tuple(DIMS), tuple(BOUNDS), 6, 1.5)),
        "corner_lerp_vector_path": tight(lambda: lc.vector_path(rays)),
        # under no_grad, as the renderer calls it: the launch alone, and
        # inside the autograd.Function that grad mode needs
        "corner_lerp_launch": tight(lambda: lc._launch(rows, w), 500),
        "corner_lerp_launch_in_function": tight(lambda: lc.CornerLerp.apply(rows, w), 500),
    }


def measure(label: str) -> None:
    """The lines of one tree, printed as JSON."""
    dev = torch.device("cuda", 0)
    name = card()
    with torch.inference_mode():
        cs = calls(dev)
        times = [(n, s, host_us(f), event_ms(f)) for n, s, f, _ in cs]
        dev_ms = [device_ms(f) for _, _, f, _ in cs]
        frame_ms = [device_ms(f, before=fo[0], only=fo[1]) if fo else None
                    for _, _, f, fo in cs]
        for (n, s, h, ms), dm, fm in zip(times, dev_ms, frame_ms):
            print("call", json.dumps(dict(tree=label, name=n, shape=s, host_us=h, ms=ms,
                                          device_ms=dm, frame_device_ms=fm, card=name)),
                  flush=True)
    from real_robot_nerf_actor_tpu_torch.ops import _build
    if hasattr(_build, "on_device"):
        with torch.no_grad():
            print("pieces_us", json.dumps(dict(tree=label, **pieces(dev), card=name)),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="a checkout of another commit")
    ap.add_argument("--measure", help=argparse.SUPPRESS)     # one tree, in this process
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return
    if not torch.cuda.is_available():
        sys.exit("launch_cost: needs a CUDA card")
    if args.against is None:
        measure("this tree")
        return
    against = args.against.resolve()
    for root, label in ((against, "against"), (ROOT, "this tree"), (ROOT, "this tree"),
                        (against, "against")):
        subprocess.run([sys.executable, __file__, "--measure", label], check=True,
                       cwd=root, env={**os.environ, "PYTHONPATH": str(root)})


if __name__ == "__main__":
    main()
