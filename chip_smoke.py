#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (real_robot_nerf_actor_tpu_torch).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each reported on its own line:
  1. build: nvcc compiles csrc/*.cu for sm_90a, one process per source, in
     parallel, into the package's git-ignored .build/ directory;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the act step gives it, with its median time,
     the plain version's, a PyTorch library call's where one computes the
     same function (timed here only, never called by the port), and the
     least time the card could take (bytes at 3.35 TB/s or flops at the
     peak rate of their type, H100 SXM data sheet);
  3. act: PolicyServer with the configs/serve.yaml policy (UNet encoder,
     100^3 x 10 voxels, 220000 points, 2048 x 512 latents, depth 6, bf16,
     random weights from a seeded generator) and the three kernel knobs on,
     driven by run_deployment over a ReplayRobotIO of the synthetic scene
     (WARMUP untimed steps, then STEPS timed ones);
     launch counts per step must be flash_attention 8, conv3d_k3 1,
     spatial_stats_3d 3. Then the same steps with the knobs off (the plain
     versions), the decoded actions side by side and the largest logit gap,
     and one step of each path under torch.profiler (device time by
     kernel, device busy share).
It fails (exit code 1, no result line) without a CUDA card, outside a
checkout, or when any phase fails. The last lines are the kernels JSON, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # tensor-core bf16; fp32 SIMT
STEPS = 10
# untimed steps first: early in a process the H100 act step alternates
# between ~20 and ~24 ms and settles after some 50 steps
WARMUP = 60
STATS_TOL = 1e-5   # stats error, of the channel's softmax denominator
STATS_SLAB = 2048  # rows per program of the stats kernel
ACT_TOL = 0.1   # logit gap of the kernel path vs the plain path, of the logit scale


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def emit(phase, **fields):
    print(f"{phase} {json.dumps(fields)}", flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def main():
    root = Path(__file__).resolve().parent
    if not (root / "real_robot_nerf_actor_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository: "
             "real_robot_nerf_actor_tpu_torch/ is missing")
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")

    from real_robot_nerf_actor_tpu_torch.data.replay import ReplayRobotIO
    from real_robot_nerf_actor_tpu_torch.data.synthetic import (
        make_replay_steps, make_synthetic_demo, make_synthetic_scene)
    from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig, PerceiverIO
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec, voxelize
    from real_robot_nerf_actor_tpu_torch.ops import _build
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import (
        flash_attention, flash_attention_plain)
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import (
        conv3d_k3, conv3d_k3_plain)
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import (
        spatial_stats_3d, spatial_stats_3d_plain)
    from real_robot_nerf_actor_tpu_torch.train.serve import (
        PolicyServer, ServeConfig, run_deployment)

    # fp32 parity: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ---------------------------------------------------------- 1. build
    emit("build", seconds=_build.build_all(), flags=_build.NVCC_FLAGS, card=card)

    # -------------------------------------------------------- 2. kernels
    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    summary = {}

    def record(name, calls, err, ms, plain_ms, bound_ms, bound_by, library_ms):
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                          bound_ms=0.0, bound_by=bound_by,
                                          library_ms=None))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += calls * ms
        s["plain_ms"] += calls * plain_ms
        s["bound_ms"] += calls * bound_ms
        if library_ms is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + calls * library_ms

    # flash attention: (heads, Nq, Nk, calls per act step); fp32 case off-path.
    # Tolerance: fp32 1e-4; bf16 2^-6 of the largest |output|, two bf16 ulps
    # of it (the outputs shrink as Nk grows: std ~ sqrt(e / Nk)).
    for heads, nq, nk, calls, dtype in [(1, 2048, 8077, 1, torch.bfloat16),
                                        (8, 2048, 2048, 6, torch.bfloat16),
                                        (1, 8077, 2048, 1, torch.bfloat16),
                                        (1, 2048, 8077, 0, torch.float32)]:
        q, k, v = (randn(1, heads, n, 64, dtype=dtype) for n in (nq, nk, nk))
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = (2 ** -6 * want.abs().max().item() if dtype == torch.bfloat16
               else 1e-4)
        dname = str(dtype).split(".")[1]
        # the tolerance must reject a kernel that skips the ragged last kv tile
        tail_err = None
        if nk % 64:
            full = nk // 64 * 64
            tail_err = (flash_attention_plain(q, k[:, :, :full], v[:, :, :full])
                        .float() - want).abs().max().item()
            if not tail_err > 2 * tol:
                fail(f"flash_attention {heads}x{nq}x{nk} {dname}: tolerance {tol} "
                     f"does not see the last {nk - full} keys dropped ({tail_err})")
        ms = median_ms(torch, lambda: flash_attention(q, k, v), 20)
        plain_ms = median_ms(torch, lambda: flash_attention_plain(q, k, v), 5)
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 20)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        b_ms, b_by = bound(4.0 * heads * nq * nk * 64, nbytes, dname)
        emit("kernel", name="flash_attention", shape=[1, heads, nq, nk, 64],
             dtype=dname, calls_per_step=calls, max_abs_err=err, tol=tol,
             tail_dropped_err=tail_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
             bound_by=b_by, card=card)
        if not err <= tol:
            fail(f"flash_attention {heads}x{nq}x{nk} {dname}: error {err} > {tol}")
        if calls:
            record("flash_attention", calls, err, ms, plain_ms, b_ms, b_by, lib_ms)

    # conv3d_k3: the policy's `final` conv, 100^3, 128 -> 64, bf16
    x = randn(1, 100, 100, 100, 128)
    w = randn(3, 3, 3, 128, 64, scale=0.03)     # cast once, as at load
    bias = randn(64, dtype=torch.float32, scale=0.1)
    got = conv3d_k3(x, w, bias)
    want = conv3d_k3_plain(x, w, bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -7 * want.float().abs().max().item()
    ms = median_ms(torch, lambda: conv3d_k3(x, w, bias), 10)
    plain_ms = median_ms(torch, lambda: conv3d_k3_plain(x, w, bias), 3)
    x_ncdhw = x.permute(0, 4, 1, 2, 3)        # channels-last view, no copy
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    b_lib = bias.to(x.dtype)
    lib_ms = median_ms(torch, lambda: F.conv3d(x_ncdhw, w_oidhw, b_lib, padding=1), 10)
    nbytes = x.numel() * 2 + w.numel() * 2 + bias.numel() * 4 + got.numel() * 2
    b_ms, b_by = bound(2.0 * 100 ** 3 * 27 * 128 * 64, nbytes, "bfloat16")
    emit("kernel", name="conv3d_k3", shape=[1, 100, 100, 100, 128, 64],
         dtype="bfloat16", calls_per_step=1, max_abs_err=err, tol=tol, ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
         card=card)
    if not err <= tol:
        fail(f"conv3d_k3: error {err} > {tol}")
    record("conv3d_k3", 1, err, ms, plain_ms, b_ms, b_by, lib_ms)
    del x, x_ncdhw, got, want

    # spatial_stats_3d: d0 (fp32), dec (fp32), u (bf16), each on inputs of
    # scale 0.3 (a few rows carry a channel's sums at the temperature 0.01)
    # and 0.01 (every row counts, the last partial slab's included). Error
    # relative to each channel's denominator, which bounds |numerators|
    # (|lin| <= 1): a numerator near zero has no relative error of its own.
    for v, c, dtype in [(100, 64, torch.float32), (20, 128, torch.float32),
                        (100, 64, torch.bfloat16)]:
        dname = str(dtype).split(".")[1]
        errs, errs_of_den = {}, {}
        for scale in (0.3, 0.01):
            feat = randn(1, v, v, v, c, dtype=dtype, scale=scale)
            got = spatial_stats_3d(feat)
            want = spatial_stats_3d_plain(feat)
            torch.cuda.synchronize()
            den = want[..., :1]
            errs[scale] = (got - want).abs().max().item()
            errs_of_den[scale] = ((got - want).abs() / den).max().item()
        # the tolerance must reject a kernel that drops the last partial slab
        n_rows = v ** 3
        cut = feat.reshape(1, n_rows, c).clone()
        cut[:, n_rows - (n_rows % STATS_SLAB or STATS_SLAB):] = float("-inf")
        tail_err = ((spatial_stats_3d_plain(cut.reshape(feat.shape)) - want).abs()
                    / den).max().item()
        del cut
        ms = median_ms(torch, lambda: spatial_stats_3d(feat), 20)
        plain_ms = median_ms(torch, lambda: spatial_stats_3d_plain(feat), 5)
        # ~10 fp32 operations an element (sub, mul, exp, 4 adds, 3 muls)
        b_ms, b_by = bound(10.0 * feat.numel(), feat.numel() * feat.element_size()
                           + c * 4 + got.numel() * 4, "float32")
        emit("kernel", name="spatial_stats_3d", shape=[1, v, v, v, c], dtype=dname,
             calls_per_step=1, input_scales=list(errs), max_abs_err=max(errs.values()),
             max_err_of_den=list(errs_of_den.values()), tol_of_den=STATS_TOL,
             tail_dropped_err_of_den=tail_err,
             ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
             bound_by=b_by, card=card)
        if not max(errs_of_den.values()) <= STATS_TOL:
            fail(f"spatial_stats_3d {v}^3x{c} {dname}: error {errs_of_den} "
                 "of the denominator")
        if not tail_err > 10 * STATS_TOL:
            fail(f"spatial_stats_3d {v}^3x{c} {dname}: tolerance does not see "
                 f"the last slab dropped ({tail_err})")
        record("spatial_stats_3d", 1, max(errs.values()), ms, plain_ms, b_ms, b_by,
               None)
        del feat

    # ------------------------------------------------------------ 3. act
    cfg_on = PerceiverConfig(depth=6, voxel_size=100, initial_dim=10,
                             num_latents=2048, latent_dim=512,
                             input_encoder="unet", return_voxel_feat=True,
                             compute_dtype="bfloat16", use_flash_attention=True,
                             conv_backend="pallas", stats_backend="pallas")
    cfg_off = dataclasses.replace(cfg_on, use_flash_attention=False,
                                  conv_backend="conv2d", stats_backend="xla")
    spec = VoxelizerSpec(voxel_size=100, feature_size=3, max_num_coords=220000)
    serve_cfg = ServeConfig(coord_bounds=(-0.1, -0.3, -0.2, 0.8, 0.7, 0.7))
    lang = np.zeros((77, 512), np.float32)
    t0 = time.perf_counter()
    sd_on = PerceiverIO.initialized(cfg_on, torch.Generator().manual_seed(0)).state_dict()
    sd_off = dict(sd_on)
    sd_off["final.Conv_0.weight"] = sd_off.pop("final.pallas_kernel").permute(4, 3, 0, 1, 2)
    sd_off["final.Conv_0.bias"] = sd_off.pop("final.pallas_bias")
    server_on = PolicyServer(serve_cfg, cfg_on, spec, sd_on, lang, device=dev)
    server_off = PolicyServer(serve_cfg, cfg_off, spec, sd_off, lang, device=dev)
    scene = make_synthetic_scene(seed=0)
    steps = make_replay_steps(scene, make_synthetic_demo(scene))
    setup_s = time.perf_counter() - t0

    def drive(server):
        """WARMUP steps, then STEPS timed steps; returns (trace, step ms)."""
        run_deployment(server, ReplayRobotIO(steps), num_steps=WARMUP)
        torch.cuda.synchronize()
        times = []
        act = server.act

        def timed(*args):
            t = time.perf_counter()
            out = act(*args)
            times.append((time.perf_counter() - t) * 1e3)
            return out

        server.act = timed
        try:
            counters = (flash_attention, conv3d_k3, spatial_stats_3d)
            for c in counters:
                c.launches = 0
            trace = run_deployment(server, ReplayRobotIO(steps), num_steps=STEPS)
            launches = {c.__name__: c.launches for c in counters}
        finally:
            server.act = act
        return trace, times, launches

    trace_on, times_on, launches = drive(server_on)
    per_step = {k: n / STEPS for k, n in launches.items()}
    emit("act", path="kernels", steps=STEPS, p50_ms=statistics.median(times_on),
         step_ms=times_on, launches=launches, launches_per_step=per_step,
         setup_s=setup_s, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=card)
    want_counts = {"flash_attention": 8, "conv3d_k3": 1, "spatial_stats_3d": 3}
    if per_step != want_counts:
        fail(f"launches per act step {per_step}, want {want_counts}")
    for name in summary:
        summary[name]["launches"] = launches[name]

    trace_off, times_off, launches_off = drive(server_off)
    emit("act", path="plain", steps=STEPS, p50_ms=statistics.median(times_off),
         step_ms=times_off, launches=launches_off, card=card)
    if any(launches_off.values()):
        fail(f"the plain path launched kernels: {launches_off}")

    # the two paths' logits on the first step's input
    s0 = steps[0]
    from real_robot_nerf_actor_tpu_torch.data.replay import pad_point_cloud
    from real_robot_nerf_actor_tpu_torch.ops import discretize_action
    pts, cols, valid = pad_point_cloud(s0.observation, spec.max_num_coords)
    bounds = server_on.bounds
    with torch.inference_mode():
        vox = voxelize(torch.as_tensor(pts, device=dev)[None],
                       torch.as_tensor(cols, device=dev)[None], bounds, spec,
                       valid=torch.as_tensor(valid, device=dev)[None])
        prev = discretize_action(
            torch.as_tensor(s0.proprio_xyz, device=dev)[None],
            torch.as_tensor(s0.proprio_rot, device=dev)[None],
            torch.tensor([s0.proprio_grip], device=dev),
            torch.ones(1, device=dev), bounds, 100, 5.0)
        proprio = torch.cat([prev.trans.float(), prev.rot_grip.float()], dim=-1)
        out_on = server_on.net(vox, proprio, server_on.lang)
        out_off = server_off.net(vox, proprio, server_off.lang)
    gaps = {}
    for name, a, b in zip(("q_trans", "q_rot_grip", "q_collision", "d0"),
                          out_on, out_off):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name}: bad output {tuple(a.shape)} / non-finite values")
        scale = max(1.0, b.abs().max().item())
        gaps[name] = {"max_gap": (a - b).abs().max().item(), "scale": scale}
        if gaps[name]["max_gap"] > ACT_TOL * scale:
            fail(f"{name}: kernel path differs from plain path by "
                 f"{gaps[name]['max_gap']} (scale {scale})")
    if tuple(out_on[0].shape) != (1, 100, 100, 100):
        fail(f"q_trans shape {tuple(out_on[0].shape)}")
    lo, hi = np.array(serve_cfg.coord_bounds[:3]), np.array(serve_cfg.coord_bounds[3:])
    actions = []
    for a_on, a_off in zip(trace_on, trace_off):
        for a in (a_on, a_off):
            if not (np.isfinite(a["xyz"]).all() and (a["xyz"] >= lo).all()
                    and (a["xyz"] <= hi).all() and a["gripper_open"] in (0, 1)):
                fail(f"bad action {a}")
        actions.append({k: [np.round(np.asarray(a[k], float), 4).tolist()
                            for a in (a_on, a_off)]
                        for k in ("xyz", "rotation", "gripper_open",
                                  "ignore_collision")})
    emit("act_compare", kernel_vs_plain=actions, logit_gaps=gaps,
         tol_of_scale=ACT_TOL, card=card)

    # one step of each path under the profiler: where the device time goes
    from torch.profiler import ProfilerActivity, profile
    for path, server in (("kernels", server_on), ("plain", server_off)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run_deployment(server, ReplayRobotIO(steps), num_steps=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        # device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched, which are rows of their own
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
        device_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        emit("profile", path=path, step_wall_ms=wall_ms, device_ms=device_ms,
             device_busy_share=device_ms / wall_ms,
             device_events=sum(r[2] for r in rows),
             top=[{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:15]],
             card=card)

    # ------------------------------------------------------- 4. summary
    info = {
        "flash_attention": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/flash_attention.cu",
                            "real_robot_nerf_actor_tpu/ops/attention_pallas.py:70"),
        "conv3d_k3": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/conv3d_k3.cu",
                      "real_robot_nerf_actor_tpu/ops/conv3d_pallas.py:46"),
        "spatial_stats_3d": ("triton", "real_robot_nerf_actor_tpu_torch/ops/stats_cuda.py",
                             "real_robot_nerf_actor_tpu/ops/stats_pallas.py:59"),
    }
    kernels = []
    for name, (route, source, replaces) in info.items():
        s = summary[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": s["launches"],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
