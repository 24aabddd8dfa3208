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
     peak rate of their type, H100 SXM data sheet). The attention lines add
     the key splits and blocks of each call and a planted fault (zero keys
     let into the softmax, as TMA reads the keys past Nk) that must fail
     their check; the conv line adds the brick and the bytes of x the
     kernel loads over x's size. These two also report the device time of
     the kernel and of the library call (torch.profiler), without the host's
     launch time that bounds a single timed call of a few tens of us. The
     spatial_stats_3d lines time the first (Triton) design beside the
     kernel (prev_ms, prev_device_ms), check that two calls give the same
     bits, and that the tolerance sees the kernel's last slab dropped;
  3. act: PolicyServer with the configs/serve.yaml policy (UNet encoder,
     100^3 x 10 voxels, 220000 points, 2048 x 512 latents, depth 6, bf16,
     random weights from a seeded generator) and the three kernel knobs on,
     driven by run_deployment over a ReplayRobotIO of the synthetic scene
     (WARMUP untimed steps, then STEPS timed ones);
     launch counts per step must be flash_attention 8, conv3d_k3 1,
     spatial_stats_3d 3, the attention and conv calls must all go
     through the wgmma/TMA kernels and the stats calls through
     csrc/spatial_stats.cu (their own counters). Then the same steps with
     the knobs off (the plain versions), the decoded actions side by side and the largest logit gap,
     and one step of each path under torch.profiler (device time by
     kernel, device busy share).
  4. render: the serving renderer of configs/serve.yaml (128 x 128 frame,
     occupancy sampling from the voxel channel and field probes, 16 + 8
     samples, RayPlan culling, W8A8 int8 field 64 -> 5 x 512, static
     activation scales) on the policy's own d0 and the voxelizer's
     occupancy channel, seen from the serving viewpoint of bench.py. Field
     weights random from a seeded generator. Setup (prepare,
     calibrate_int8_act, plan_rays), then its four kernels against their
     plain versions on the frame's first tile (ray_expand, corner_lerp,
     fused_resnetfc_int8 and fused_gather_resnetfc_int8 under static and
     dynamic scales). The MLP kernels run their wgmma design, which must
     equal the first (mma.sync) design bit for bit; that design is timed
     beside it (prev_ms). Then FRAME_WARMUP untimed and FRAMES timed frames
     with gather_fused_mlp false (serve.yaml as written) and true: p50 per
     frame, delivered and computed rays/s, active share, peak memory,
     launches per frame (2 per tile for each kernel of the path, and every
     MLP launch on the wgmma design). The frames of the two
     settings must be equal, and the kernel frame must stay within RGB_TOL
     (largest gap) and PSNR_MIN of the plain field's (mlp_backend "xla")
     frame. Three planted glue faults (the fine pass dropped, the field's
     rgb halved, sigma read in ray-major instead of sample-major order)
     must each fail that frame check. One frame of each setting runs under
     torch.profiler.
  5. grad: forward and backward of the `final` conv (100^3, 128 -> 64,
     bf16) and of corner_lerp (65536 x 512 bf16) with the kernel against
     the plain path (a planted fault each must fail the check), then the
     five kernels without a backward must refuse grad and run under no_grad.
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
# tensor-core bf16 and int8 (dense), fp32 SIMT; H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
STEPS = 10
# untimed steps first: early in a process the H100 act step alternates
# between ~20 and ~24 ms and settles after some 50 steps
WARMUP = 60
STATS_TOL = 1e-5   # stats error, of the channel's softmax denominator
ACT_TOL = 0.1   # logit gap of the kernel path vs the plain path, of the logit scale
# the renderer: section `renderer:` of configs/serve.yaml (tests hold the two equal)
SERVE_RENDERER = dict(image_width=128, image_height=128, z_near=1.2, z_far=4.0,
                      n_coarse=16, n_fine=8, n_fine_depth=0, ray_chunk_size=512,
                      sampling_mode="occupancy", occ_tighten=True, use_ray_plan=True,
                      occ_source="auto")
SERVE_FIELD = dict(d_latent=64, d_embed=512, d_hidden=512, n_blocks=5, combine_layer=3,
                   compute_dtype="bfloat16", mlp_backend="pallas_int8",
                   int8_static_act=True, coord_bounds=(-0.1, -0.3, -0.2, 0.8, 0.7, 0.7),
                   mask_outside=True)
FRAMES = 10
FRAME_WARMUP = 5
# fused MLP kernels vs their plain versions: the largest gap within 2^-4 of
# each output's largest |value|, and at most MLP_SHARE of the outputs more
# than one bf16 ulp of that scale (2^-8) apart. An fp32 sum that rounds one
# ulp apart can move a bf16 activation, then an int8 code, and the step
# cascades through the blocks in a few rows: the plain version itself moves
# by as much when its fp32 sums run in another order (the kernel lines'
# plain_reorder_* fields measure that)
MLP_TOL = 2 ** -4
MLP_SHARE = 1e-3
# the int8 kernel frame vs the plain field's frame, same weights and draws:
# the largest |rgb gap| (0.0225 on an H100 80GB HBM3 at 700 W, against a
# frame mean of 0.059) and the PSNR between the two (55.3 dB there; 45 dB
# is an RMS gap of 0.0056, under a tenth of the mean pixel)
RGB_TOL = 0.04
PSNR_MIN = 45.0


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


def profiled_ms(torch, fn, reps, flush=None):
    """Device time of one call, from torch.profiler: the sum of the device
    events of `reps` calls over `reps`. Unlike median_ms it leaves out the
    time the host takes to launch, which bounds calls of a few tens of
    microseconds. With `flush`, it runs before each call (to evict the L2)
    and its own device events are left out of the sum."""
    from torch.profiler import ProfilerActivity, profile

    def device_keys(run):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0}

    fn()
    torch.cuda.synchronize()
    skip = set(device_keys(flush)) if flush else set()

    def run():
        for _ in range(reps):
            if flush:
                flush()
            fn()

    total = sum(t for k, t in device_keys(run).items() if k not in skip)
    return total / reps / 1e3 if total > 0 else None   # None: the profiler saw nothing


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def random_field_state(torch, renderer, seed):
    """Every field weight random from a seeded generator, std fan_in^-1/2
    (a flax init zeroes each block's second dense, which would leave half
    the int8 products empty), biases zero, the density bias 1.0 so the
    frame is not empty (bench.py does the same)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in renderer.field.state_dict().items():
        if v.dim() == 2:
            fan_in = v.shape[0] if k.endswith("lin_out_kernel") else v.shape[1]
            sd[k] = torch.randn(v.shape, generator=g) * fan_in ** -0.5
        else:
            sd[k] = torch.zeros(v.shape)
    sd["mlp_coarse.lin_out_bias"][3] = 1.0
    return sd


def render_phase(torch, np, dev, card, d0, occupancy, summary, record):
    """Phase 4: the serving renderer of configs/serve.yaml on the policy's d0."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.data.synthetic import _look_at
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig
    from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf
    from real_robot_nerf_actor_tpu_torch.ops.grid_sample import expand_corners
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp, corner_lerp_plain
    from real_robot_nerf_actor_tpu_torch.ops.occupancy import sample_occupancy, tighten_rays
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import (
        ray_expand, ray_expand_plain)
    from real_robot_nerf_actor_tpu_torch.ops.sampling import sample_importance_z
    from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, RendererConfig, psnr

    d0 = d0.float().contiguous()
    t0 = time.perf_counter()

    def make(renderer_kw=None, **field_kw):
        cfg = RendererConfig(field=NerfFieldConfig(**dict(SERVE_FIELD, **field_kw)),
                             **dict(SERVE_RENDERER, **(renderer_kw or {})))
        return NeuralRenderer(cfg, device=dev)

    r = make()
    sd = random_field_state(torch, r, seed=1)
    r.load_field(sd)
    center = np.array([0.35, 0.2, 0.1], np.float32)
    pose = _look_at(center + np.array([0.9, -0.75, 0.85], np.float32), center)[None]
    focal = 76.18 * 128.0 / 80.0
    cuda_gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    occ = r.prepare(d0, occupancy=occupancy, generator=cuda_gen(2))
    rays_frame = r.frame_rays(pose, focal)
    scales = r.calibrate_int8_act(d0, rays_frame, generator=cuda_gen(3))
    plan = r.plan_rays(occ, pose, focal)
    torch.cuda.synchronize()
    cfg = r.cfg
    tile = min(cfg.render_tile, plan.idx.numel())
    n_tiles = plan.idx.numel() // tile
    emit("render_setup", setup_s=time.perf_counter() - t0, d0_shape=list(d0.shape),
         occupied_cells=int(occ.pooled.sum().item()), aabb=occ.aabb.tolist(),
         static_scales=list(scales), n_active=plan.n_active, n_total=plan.n_total,
         capacity=plan.idx.numel(), tile=tile, tiles=n_tiles, card=card)
    if not 0 < plan.n_active < plan.n_total:
        fail(f"render: the plan keeps {plan.n_active} of {plan.n_total} rays")

    # ---- the four kernels on the frame's first tile, against their plain versions
    bounds = torch.as_tensor(SERVE_FIELD["coord_bounds"], dtype=torch.float32, device=dev)
    exp = expand_corners(d0.to(torch.bfloat16))
    rows_all = exp.reshape(-1, exp.shape[-1])
    tile_rays = tighten_rays(rays_frame[plan.idx[:tile].clamp(max=plan.n_total - 1)],
                             occ.aabb, bounds).contiguous()
    g = cuda_gen(4)
    z_coarse = sample_occupancy(tile_rays, occ.pooled, cfg.n_coarse, bounds,
                                cfg.occ_probes, cfg.occ_floor, generator=g)
    # the fine pass's importance samples, drawn as render_rays draws them:
    # from the weights of this tile's coarse pass
    w_coarse = r._eval_pass(exp, tile_rays, z_coarse, True, pre_expanded=True,
                            compact=r._late_embed_active()).weights
    z_by_pass = {"coarse": z_coarse,
                 "fine": sample_importance_z(z_coarse, w_coarse, cfg.n_fine, generator=g)}
    packed = r._packed
    kp = packed["kernel"]
    # the weights once: the wgmma kernel reads wq_ring in wq's place
    wbytes = sum(v.numel() * v.element_size() for k, v in kp.items()
                 if isinstance(v, torch.Tensor) and k != "wq_ring")
    f = SERVE_FIELD
    dims = tuple(d0.shape[1:4])
    nb, cl = f["n_blocks"], f["combine_layer"]
    int8_ops, bf16_ops = rf.mlp_ops_per_row(f["d_hidden"], f["n_blocks"], f["combine_layer"],
                                            kp["k_in"], kp["k_lat"], True)
    static_t = r._act_scales_t
    for pass_, z in z_by_pass.items():
        z = z.contiguous()
        k = z.shape[1]
        n = k * tile
        # ray_expand: bit-equal to the torch ops (round-to-nearest intrinsics)
        got = ray_expand(tile_rays, z, dims, SERVE_FIELD["coord_bounds"])
        want = ray_expand_plain(tile_rays, z, dims, SERVE_FIELD["coord_bounds"])
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"ray_expand {pass_}: differs from its plain version ({err})")
        aux, w8, flat = got[0].reshape(-1, n), got[1].reshape(8, n), got[2].reshape(n)
        ms = median_ms(torch, lambda: ray_expand(tile_rays, z, dims,
                                                 SERVE_FIELD["coord_bounds"]), 20)
        plain_ms = median_ms(torch, lambda: ray_expand_plain(
            tile_rays, z, dims, SERVE_FIELD["coord_bounds"]), 5)
        nbytes = tile * 8 * 4 + n * 4 + n * (aux.shape[0] * 2 + 8 * 4 + 4)
        b_ms, b_by = bound(120.0 * n, nbytes, "float32")
        emit("kernel", name="ray_expand", shape=[tile, k], dtype="float32",
             calls_per_frame=n_tiles, max_abs_err=err, tol=0.0, ms=ms, plain_ms=plain_ms,
             library_ms=None, bound_ms=b_ms, bound_by=b_by, card=card)
        record("ray_expand", n_tiles, err, ms, plain_ms, b_ms, b_by, None)

        # corner_lerp on the gathered rows: one bf16 ulp (<= 2^-7 of each value)
        rows = rows_all[flat.long()]
        got = corner_lerp(rows, w8)
        want = corner_lerp_plain(rows, w8).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        if not ((got.float() - want).abs() <= 2 ** -7 * want.abs() + 1e-6).all():
            fail(f"corner_lerp {pass_}: more than one bf16 ulp from its plain version")
        no_last = corner_lerp_plain(rows, w8 * torch.tensor([1.0] * 7 + [0.0], device=dev)[:, None])
        if not ((no_last.float() - want).abs() > 2 ** -7 * want.abs() + 1e-6).any():
            fail(f"corner_lerp {pass_}: the check does not see a dropped corner")
        ms = median_ms(torch, lambda: corner_lerp(rows, w8), 20)
        plain_ms = median_ms(torch, lambda: corner_lerp_plain(rows, w8), 5)
        rows3, w_lib = rows.view(n, 8, -1), w8.T.unsqueeze(1).to(torch.bfloat16).contiguous()
        lib_ms = median_ms(torch, lambda: torch.bmm(w_lib, rows3), 20)
        nbytes = rows.numel() * 2 + w8.numel() * 4 + got.numel() * 2
        b_ms, b_by = bound(16.0 * got.numel(), nbytes, "float32")
        emit("kernel", name="corner_lerp", shape=list(rows.shape), dtype="bfloat16",
             calls_per_frame=n_tiles, max_abs_err=err, tol="2^-7 of each value", ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, card=card)
        record("corner_lerp", n_tiles, err, ms, plain_ms, b_ms, b_by, lib_ms)

        zi = r._assemble_zi_int8(exp, tile_rays, z)[0]
        # the fused MLP kernels, static (the main path) and dynamic scales;
        # the wgmma design against the plain version and against the first
        # design (bit for bit), with the weight bytes each call reads from
        # L2 (all block matrices once per 64-row tile)
        t_ops = n * (int8_ops / PEAK_FLOPS["int8"] + bf16_ops / PEAK_FLOPS["bfloat16"])
        l2_bytes = -(-n // 64) * kp["wq"].numel()
        for mode, sc in (("static", static_t), ("dynamic", None)):
            calls = n_tiles if mode == "static" else 0
            gkw = dict(d_latent=f["d_latent"], n_blocks=nb, combine_layer=cl, act_scales=sc)
            wgmma = rf.fused_resnetfc_int8.wgmma_launches
            got = rf.fused_resnetfc_int8(zi, packed, nb, cl, act_scales=sc)
            if rf.fused_resnetfc_int8.wgmma_launches != wgmma + 1:
                fail(f"fused_resnetfc_int8 {pass_} {mode}: did not reach the wgmma design")
            prev = rf.fused_resnetfc_int8(zi, packed, nb, cl, act_scales=sc, design="mma_sync")
            want = rf.fused_resnetfc_int8_plain(zi, packed, nb, cl, act_scales=sc)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, prev)):
                fail(f"fused_resnetfc_int8 {pass_} {mode}: the wgmma design differs from "
                     "the mma.sync design")
            err, tol, over = mlp_err(got, want)
            wrong = rf.fused_resnetfc_int8_plain(zi, packed, nb, cl - 1, act_scales=sc)
            wrong_err, _, wrong_over = mlp_err(wrong, want)
            dot32 = rf._dot         # the plain version with its sums in float64
            rf._dot = lambda a, w: (a.double() @ w.double()).float()
            reorder = rf.fused_resnetfc_int8_plain(zi, packed, nb, cl, act_scales=sc)
            rf._dot = dot32
            reorder_err, _, reorder_over = mlp_err(reorder, want)
            if not (err <= tol and over <= MLP_SHARE):
                fail(f"fused_resnetfc_int8 {pass_} {mode}: error {err} (tolerance {tol}), "
                     f"{over} of the outputs over one ulp (at most {MLP_SHARE})")
            if not (wrong_err > tol or wrong_over > MLP_SHARE):
                fail(f"fused_resnetfc_int8 {pass_} {mode}: the tolerance does not see "
                     f"the block-2 injection dropped ({wrong_err})")
            ms = median_ms(torch, lambda: rf.fused_resnetfc_int8(zi, packed, nb, cl, act_scales=sc), 10)
            prev_ms = median_ms(torch, lambda: rf.fused_resnetfc_int8(
                zi, packed, nb, cl, act_scales=sc, design="mma_sync"), 10)
            plain_ms = median_ms(torch, lambda: rf.fused_resnetfc_int8_plain(
                zi, packed, nb, cl, act_scales=sc), 3)
            nbytes = zi.numel() * 2 + wbytes + n * (128 + f["d_hidden"]) * 2
            b_ms = max(t_ops, nbytes / PEAK_BYTES_PER_S) * 1e3
            b_by = "operations" if t_ops > nbytes / PEAK_BYTES_PER_S else "bytes"
            emit("kernel", name="fused_resnetfc_int8", shape=[n, 128], scales=mode,
                 design="wgmma", equals_prev=True, prev_ms=prev_ms,
                 l2_weight_bytes=l2_bytes,
                 calls_per_frame=calls, max_abs_err=err, tol=tol, share_over_ulp=over,
                 share_tol=MLP_SHARE, plain_reorder_err=reorder_err,
                 plain_reorder_share_over_ulp=reorder_over, injection_dropped_err=wrong_err,
                 injection_dropped_share_over_ulp=wrong_over, ms=ms, plain_ms=plain_ms,
                 library_ms=None, bound_ms=b_ms, bound_by=b_by, card=card)
            if calls:
                record("fused_resnetfc_int8", calls, err, ms, plain_ms, b_ms, b_by, None)

            unfused = got
            wgmma = rf.fused_gather_resnetfc_int8.wgmma_launches
            got = rf.fused_gather_resnetfc_int8(rows_all, flat, w8, aux, packed, **gkw)
            if rf.fused_gather_resnetfc_int8.wgmma_launches != wgmma + 1:
                fail(f"fused_gather_resnetfc_int8 {pass_} {mode}: did not reach the wgmma "
                     "design")
            prev = rf.fused_gather_resnetfc_int8(rows_all, flat, w8, aux, packed,
                                                 design="mma_sync", **gkw)
            want = rf.fused_gather_resnetfc_int8_plain(rows_all, flat, w8, aux, packed,
                                                       **gkw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, unfused)):
                fail(f"fused_gather_resnetfc_int8 {pass_} {mode}: differs from "
                     "ray_expand -> corner_lerp -> fused_resnetfc_int8")
            if not all(torch.equal(a, b) for a, b in zip(got, prev)):
                fail(f"fused_gather_resnetfc_int8 {pass_} {mode}: the wgmma design differs "
                     "from the mma.sync design")
            err, tol, over = mlp_err(got, want)
            if not (err <= tol and over <= MLP_SHARE):
                fail(f"fused_gather_resnetfc_int8 {pass_} {mode}: error {err} (tolerance "
                     f"{tol}), {over} of the outputs over one ulp")
            ms = median_ms(torch, lambda: rf.fused_gather_resnetfc_int8(
                rows_all, flat, w8, aux, packed, **gkw), 10)
            prev_ms = median_ms(torch, lambda: rf.fused_gather_resnetfc_int8(
                rows_all, flat, w8, aux, packed, design="mma_sync", **gkw), 10)
            plain_ms = median_ms(torch, lambda: rf.fused_gather_resnetfc_int8_plain(
                rows_all, flat, w8, aux, packed, **gkw), 3)
            nbytes = n * (rows_all.shape[1] * 2 + 4 + 8 * 4 + aux.shape[0] * 2) + wbytes \
                + n * (128 + f["d_hidden"]) * 2
            b_ms = max(t_ops, nbytes / PEAK_BYTES_PER_S) * 1e3
            b_by = "operations" if t_ops > nbytes / PEAK_BYTES_PER_S else "bytes"
            emit("kernel", name="fused_gather_resnetfc_int8", shape=[n, rows_all.shape[1]],
                 scales=mode, design="wgmma", equals_prev=True, prev_ms=prev_ms,
                 l2_weight_bytes=l2_bytes,
                 calls_per_frame=calls, max_abs_err=err, tol=tol, share_over_ulp=over,
                 share_tol=MLP_SHARE, equals_unfused=True,
                 ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                 card=card)
            if calls:
                record("fused_gather_resnetfc_int8", calls, err, ms, plain_ms, b_ms, b_by,
                       None)
    del exp, rows_all, rows, zi, prev

    # ---- frames: serve.yaml as written, then gather_fused_mlp = true
    mlp_counters = (rf.fused_resnetfc_int8, rf.fused_gather_resnetfc_int8)
    counters = (ray_expand, corner_lerp) + mlp_counters

    def frames(rend, seed):
        """FRAME_WARMUP untimed, FRAMES timed frames; the last frame's output,
        the frame times and the launches of the timed frames."""
        for i in range(FRAME_WARMUP):
            rend.render_image(d0, pose, focal, generator=cuda_gen(seed), occ=occ, plan=plan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        for c in mlp_counters:
            c.wgmma_launches = 0
        times = []
        for i in range(FRAMES):
            t = time.perf_counter()
            out = rend.render_image(d0, pose, focal, generator=cuda_gen(seed), occ=occ,
                                    plan=plan)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = {c.__name__: c.launches for c in counters}
        launches.update({f"{c.__name__}_wgmma": c.wgmma_launches for c in mlp_counters})
        return out, times, launches, torch.cuda.max_memory_allocated() / 2 ** 30

    r_gf = make(gather_fused_mlp=True)
    r_gf.load_field(sd)
    r_gf._int8_act_scales, r_gf._act_scales_t = r._int8_act_scales, r._act_scales_t
    outs = {}
    for label, rend, on_path in (("unfused", r, ("ray_expand", "corner_lerp",
                                                 "fused_resnetfc_int8")),
                                 ("gather_fused", r_gf, ("ray_expand",
                                                         "fused_gather_resnetfc_int8"))):
        out, times, launches, peak = frames(rend, 100)
        outs[label] = out
        per_frame = {k: v / FRAMES for k, v in launches.items()}
        p50 = statistics.median(times)
        emit("render", gather_fused_mlp=label == "gather_fused", frames=FRAMES,
             p50_ms=p50, frame_ms=times, delivered_rays_per_s=plan.n_total / p50 * 1e3,
             computed_rays_per_s=plan.n_active / p50 * 1e3,
             active_share=plan.n_active / plan.n_total, launches=launches,
             launches_per_frame=per_frame, peak_mem_gb=peak, card=card)
        # every MLP launch of the path on the wgmma design
        want = {k: (2 * n_tiles if k.removesuffix("_wgmma") in on_path else 0)
                for k in per_frame}
        if per_frame != want:
            fail(f"render {label}: launches per frame {per_frame}, want {want}")
        for k in on_path:
            if k != "ray_expand" or label == "unfused":
                summary[k]["launches"] = launches[k + "_wgmma" if k.startswith("fused")
                                                  else k]
        for name, x in zip(("rgb", "embed", "depth"), out):
            if not torch.isfinite(x).all():
                fail(f"render {label}: non-finite {name}")
        hw = (cfg.image_height, cfg.image_width)
        if tuple(out[0].shape) != hw + (3,) or tuple(out[1].shape) != hw + (f["d_embed"],):
            fail(f"render {label}: frame shapes {tuple(out[0].shape)}, {tuple(out[1].shape)}")

    gaps = {name: (a - b).abs().max().item()
            for name, a, b in zip(("rgb", "embed", "depth"), outs["unfused"],
                                  outs["gather_fused"])}
    # the plain field (mlp_backend "xla"), same weights, draws, occupancy, plan
    r_x = make(mlp_backend="xla")
    r_x.load_field(sd)
    out_x = r_x.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)
    rgb_x = out_x[0]

    def frame_check(rgb):
        """(largest |rgb gap|, PSNR dB) against the plain field's frame, and
        whether both are within their limits."""
        gap, db = (rgb - rgb_x).abs().max().item(), psnr(rgb, rgb_x).item()
        return gap, db, gap <= RGB_TOL and db >= PSNR_MIN

    rgb_gap, rgb_db, rgb_ok = frame_check(outs["unfused"][0])
    # planted faults in the renderer's glue around the kernels: each must
    # fail the frame check
    r_coarse = make(renderer_kw=dict(n_fine=0))        # the fine pass dropped
    r_coarse.load_field(sd)
    r_coarse._int8_act_scales, r_coarse._act_scales_t = scales, static_t
    field_out = r._eval_points_fused_int8
    faults = {"fine_pass_dropped": lambda: r_coarse.render_image(
        d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)}

    def with_field_fault(fault):
        def run():
            r._eval_points_fused_int8 = lambda *a: fault(*field_out(*a))
            try:
                return r.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ,
                                      plan=plan)
            finally:
                del r._eval_points_fused_int8
        return run

    faults["rgb_halved"] = with_field_fault(lambda rgb, sig, h: (0.5 * rgb, sig, h))
    faults["sigma_ray_major"] = with_field_fault(
        lambda rgb, sig, h: (rgb, sig.T.reshape(sig.shape), h))
    fault_checks = {}
    for name, run in faults.items():
        gap, db, ok = frame_check(run()[0])
        fault_checks[name] = {"max_rgb_gap": gap, "psnr_db": db, "passes_check": ok}
    lit = rgb_x.amax().item()
    emit("render_compare", gather_fused_vs_unfused_max_gap=gaps,
         kernel_vs_xla_max_rgb_gap=rgb_gap, rgb_tol=RGB_TOL,
         kernel_vs_xla_psnr_db=rgb_db, psnr_min_db=PSNR_MIN,
         kernel_vs_xla_depth_gap=(outs["unfused"][2] - out_x[2]).abs().max().item(),
         xla_rgb_max=lit, xla_rgb_mean=rgb_x.mean().item(), planted_faults=fault_checks,
         card=card)
    if any(v > 1e-6 for v in gaps.values()):
        fail(f"render: the gather-fused frame differs from the unfused one: {gaps}")
    if not rgb_ok:
        fail(f"render: kernel frame vs plain field frame, rgb gap {rgb_gap} (at most "
             f"{RGB_TOL}), PSNR {rgb_db} dB (at least {PSNR_MIN})")
    for name, c in fault_checks.items():
        if c["passes_check"]:
            fail(f"render: the frame check does not see the planted fault {name}: {c}")
    if not lit > 0.05:
        fail(f"render: the frame is empty (largest rgb {lit})")

    for label, rend in (("unfused", r), ("gather_fused", r_gf)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            rend.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
        device_ms = sum(x[1] for x in rows)
        rows.sort(key=lambda x: -x[1])
        ranges = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                  if e.key in ("expand_corners",)}
        emit("render_profile", gather_fused_mlp=label == "gather_fused",
             frame_wall_ms=wall_ms, device_ms=device_ms,
             device_busy_share=device_ms / wall_ms, ranges_device_ms=ranges,
             device_events=sum(x[2] for x in rows),
             top=[{"name": nm[:80], "ms": ms, "count": c} for nm, ms, c in rows[:15]],
             card=card)
    return r._packed


def grad_phase(torch, dev, card, packed):
    """Phase 5: gradients on the card. `final`'s conv (100^3, 128 -> 64,
    bf16) and corner_lerp (65536 x 512 bf16), forward and backward with the
    kernel against the plain path, each with a planted fault that must fail
    its check; then the five kernels without a backward must refuse an input
    that requires a gradient, and run under no_grad."""
    from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import (
        conv3d_k3, conv3d_k3_plain, conv3d_k3_vjp)
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp, corner_lerp_plain
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def gap_of_scale(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # the conv: one output gradient through the kernel's Function and through
    # autograd of the plain version; the Function's gradients must also equal
    # its own backward code (conv3d_k3_vjp) bit for bit. Tolerances of each
    # gradient's scale: the bf16 output, dx and dk 2^-7 (one rounding, sums
    # in another order), the fp32 db 1e-5.
    torch.backends.cudnn.deterministic = True
    x = randn(1, 100, 100, 100, 128).requires_grad_()
    w = randn(3, 3, 3, 128, 64, scale=0.03).requires_grad_()
    b = randn(64, dtype=torch.float32, scale=0.1).requires_grad_()
    g = randn(1, 100, 100, 100, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = conv3d_k3(x, w, b)
    y.backward(g)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    got = (x.grad, w.grad, b.grad)
    with torch.no_grad():
        same = all(torch.equal(a, c) for a, c in zip(got, conv3d_k3_vjp(x, w, g)))
    xp, wp, bp = (t.detach().clone().requires_grad_() for t in (x, w, b))
    yp = conv3d_k3_plain(xp, wp, bp)
    yp.backward(g)
    torch.cuda.synchronize()
    gaps = {"out": gap_of_scale(y.detach(), yp.detach())}
    gaps.update({k: gap_of_scale(a, c) for k, a, c in
                 zip(("dx", "dk", "db"), got, (xp.grad, wp.grad, bp.grad))})
    tols = {"out": 2 ** -7, "dx": 2 ** -7, "dk": 2 ** -7, "db": 1e-5}
    # planted: the taps of dk flipped (the error of a transposed conv whose
    # kernel is not flipped back)
    flipped = gap_of_scale(w.grad.flip(0, 1, 2), wp.grad)
    emit("grad", name="conv3d_k3", shape=[1, 100, 100, 100, 128, 64], dtype="bfloat16",
         gap_of_scale=gaps, tol_of_scale=tols, equals_own_backward=same,
         dk_taps_flipped_gap=flipped, kernel_fwd_bwd_s=kernel_s, card=card)
    torch.backends.cudnn.deterministic = False
    if not same:
        fail("grad conv3d_k3: the Function's gradients differ from conv3d_k3_vjp")
    if any(gaps[k] > tols[k] for k in gaps):
        fail(f"grad conv3d_k3: {gaps} over {tols}")
    if not flipped > tols["dk"]:
        fail(f"grad conv3d_k3: the check does not see dk's taps flipped ({flipped})")
    del x, w, g, y, yp, xp, wp, got

    # corner_lerp: out and d_rows within one bf16 ulp of each value, d_w
    # 1e-5 of its scale; planted: d_w with its corners rolled
    m = 65536
    rows = randn(m, 512).requires_grad_()
    w8 = torch.rand((8, m), generator=gen, device=dev).requires_grad_()
    g = randn(m, 64)
    y = corner_lerp(rows, w8)
    y.backward(g)
    rp, wp = rows.detach().clone().requires_grad_(), w8.detach().clone().requires_grad_()
    yp = corner_lerp_plain(rp, wp)
    yp.backward(g)
    torch.cuda.synchronize()

    def within_ulp(a, c):   # the kernel line's check: 2^-7 of each value (+ 1e-6)
        return bool(((a.float() - c.float()).abs() <= 2 ** -7 * c.float().abs() + 1e-6)
                    .all())

    ulps = {"out": within_ulp(y.detach(), yp.detach()),
            "d_rows": within_ulp(rows.grad, rp.grad)}
    d_w_gap = gap_of_scale(w8.grad, wp.grad)
    rolled = gap_of_scale(w8.grad.roll(1, 0), wp.grad)
    emit("grad", name="corner_lerp", shape=[m, 512], dtype="bfloat16",
         within_one_ulp=ulps, d_w_gap_of_scale=d_w_gap, tol_of_scale=1e-5,
         d_w_corners_rolled_gap=rolled, card=card)
    if not (all(ulps.values()) and d_w_gap <= 1e-5):
        fail(f"grad corner_lerp: kernel path vs plain path {ulps}, d_w {d_w_gap}")
    if not rolled > 1e-5:
        fail(f"grad corner_lerp: the check does not see d_w's corners rolled ({rolled})")
    del rows, w8, g, y, yp, rp, wp

    # the five kernels without a backward refuse grad, and run under no_grad
    n = 256
    q = randn(1, 1, 128, 64).requires_grad_()
    vol = randn(1, 20, 20, 20, 128, dtype=torch.float32).requires_grad_()
    rays = torch.cat([randn(n, 6, dtype=torch.float32, scale=0.3),
                      torch.zeros((n, 2), device=dev)], 1)
    z = torch.rand((n, 4), generator=gen, device=dev).requires_grad_()
    zi = torch.zeros((n, 128), dtype=torch.bfloat16, device=dev).requires_grad_()
    vox = torch.zeros((27, 512), dtype=torch.bfloat16, device=dev).requires_grad_()
    flat = torch.zeros(n, dtype=torch.int32, device=dev)
    w8 = torch.full((8, n), 0.125, device=dev)
    aux = torch.zeros((packed["kernel"]["n_aux"], n), dtype=torch.bfloat16, device=dev)
    calls = {
        "flash_attention": lambda: flash_attention(q, q, q),
        "spatial_stats_3d": lambda: spatial_stats_3d(vol),
        "ray_expand": lambda: ray_expand(rays, z, (2, 2, 2), (0, 0, 0, 1, 1, 1)),
        "fused_resnetfc_int8": lambda: rf.fused_resnetfc_int8(zi, packed),
        "fused_gather_resnetfc_int8": lambda: rf.fused_gather_resnetfc_int8(
            vox, flat, w8, aux, packed),
    }
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = False
        except RuntimeError as e:
            refused[name] = name in str(e) and "requires a gradient" in str(e)
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    emit("grad", name="refusals", refused_under_grad=refused, card=card)
    if not all(refused.values()):
        fail(f"grad: a kernel without a backward did not refuse grad: {refused}")


def mlp_err(got, want):
    """(largest gap, tolerance MLP_TOL of the largest |output|) over out and
    hidden, and the share of outputs more than one bf16 ulp of that scale
    (2^-8) apart."""
    errs, tols, over = [], [], []
    for a, b in zip(got, want):
        gap = (a.float() - b.float()).abs()
        scale = b.float().abs().max().item()
        errs.append(gap.max().item())
        tols.append(MLP_TOL * scale)
        over.append((gap > 2 ** -8 * scale).float().mean().item())
    worst = max(range(len(errs)), key=lambda i: errs[i] / max(tols[i], 1e-30))
    return errs[worst], tols[worst], max(over)


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
        BRICK, conv3d_k3, conv3d_k3_plain, halo_bytes)
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import (
        spatial_stats_3d, spatial_stats_3d_plain, spatial_stats_3d_triton_prev)
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
        wgmma = flash_attention.wgmma_launches
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v).float()
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        if flash_attention.wgmma_launches != wgmma + bf16:
            fail(f"flash_attention {heads}x{nq}x{nk}: bf16 must reach the wgmma kernel, "
                 "fp32 the SIMT one")
        plan = flash_attention.last_plan if bf16 else {"splits": 1, "blocks": None}
        err = (got.float() - want).abs().max().item()
        tol = (2 ** -6 * want.abs().max().item() if dtype == torch.bfloat16
               else 1e-4)
        dname = str(dtype).split(".")[1]
        # planted fault: the keys past Nk that TMA reads as zeros let into
        # the softmax. On inputs whose real scores are all about -24 the
        # plain version with those zero keys appended must fail the check,
        # and the kernel must pass it.
        pad_fault_err = pad_kernel_err = None
        if bf16 and nk % 64:
            u = torch.ones(64, device=dev)
            qp = (u + 0.1 * torch.randn(1, heads, nq, 64, generator=gen, device=dev)).to(dtype)
            kp = (-3.0 * (u + 0.1 * torch.randn(1, heads, nk, 64, generator=gen,
                                                device=dev))).to(dtype)
            vp = randn(1, heads, nk, 64, dtype=dtype)
            want_p = flash_attention_plain(qp, kp, vp).float()
            tol_p = 2 ** -6 * want_p.abs().max().item()
            pad_kernel_err = (flash_attention(qp, kp, vp).float() - want_p).abs().max().item()
            zeros = torch.zeros((1, heads, 64 - nk % 64, 64), device=dev, dtype=dtype)
            pad_fault_err = (flash_attention_plain(qp, torch.cat([kp, zeros], 2),
                                                   torch.cat([vp, zeros], 2)).float()
                             - want_p).abs().max().item()
            if not pad_kernel_err <= tol_p:
                fail(f"flash_attention {heads}x{nq}x{nk}: padded-key inputs, error "
                     f"{pad_kernel_err} > {tol_p}")
            if not pad_fault_err > 2 * tol_p:
                fail(f"flash_attention {heads}x{nq}x{nk}: the check does not see zero "
                     f"keys let into the softmax ({pad_fault_err}, tolerance {tol_p})")
            del qp, kp, vp
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
        dev_ms = profiled_ms(torch, lambda: flash_attention(q, k, v), 20)
        lib_dev_ms = profiled_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 20)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        b_ms, b_by = bound(4.0 * heads * nq * nk * 64, nbytes, dname)
        emit("kernel", name="flash_attention", shape=[1, heads, nq, nk, 64],
             dtype=dname, design="wgmma" if bf16 else "simt", splits=plan["splits"],
             blocks=plan["blocks"], calls_per_step=calls, max_abs_err=err, tol=tol,
             tail_dropped_err=tail_err, padded_keys_kernel_err=pad_kernel_err,
             padded_keys_fault_err=pad_fault_err, ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms,
             bound_ms=b_ms, bound_by=b_by, card=card)
        if not err <= tol:
            fail(f"flash_attention {heads}x{nq}x{nk} {dname}: error {err} > {tol}")
        if calls:
            record("flash_attention", calls, err, ms, plain_ms, b_ms, b_by, lib_ms)

    # conv3d_k3: the policy's `final` conv, 100^3, 128 -> 64, bf16
    x = randn(1, 100, 100, 100, 128)
    w = randn(3, 3, 3, 128, 64, scale=0.03)     # cast once, as at load
    bias = randn(64, dtype=torch.float32, scale=0.1)
    wgmma = conv3d_k3.wgmma_launches
    got = conv3d_k3(x, w, bias)
    want = conv3d_k3_plain(x, w, bias)
    torch.cuda.synchronize()
    if conv3d_k3.wgmma_launches != wgmma + 1:
        fail("conv3d_k3: the `final` conv did not reach the wgmma kernel")
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -7 * want.float().abs().max().item()
    ms = median_ms(torch, lambda: conv3d_k3(x, w, bias), 10)
    plain_ms = median_ms(torch, lambda: conv3d_k3_plain(x, w, bias), 3)
    x_ncdhw = x.permute(0, 4, 1, 2, 3)        # channels-last view, no copy
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    b_lib = bias.to(x.dtype)
    lib_ms = median_ms(torch, lambda: F.conv3d(x_ncdhw, w_oidhw, b_lib, padding=1), 10)
    dev_ms = profiled_ms(torch, lambda: conv3d_k3(x, w, bias), 10)
    lib_dev_ms = profiled_ms(torch, lambda: F.conv3d(x_ncdhw, w_oidhw, b_lib, padding=1), 10)
    nbytes = x.numel() * 2 + w.numel() * 2 + bias.numel() * 4 + got.numel() * 2
    b_ms, b_by = bound(2.0 * 100 ** 3 * 27 * 128 * 64, nbytes, "bfloat16")
    emit("kernel", name="conv3d_k3", shape=[1, 100, 100, 100, 128, 64],
         dtype="bfloat16", design="wgmma", brick_xyz=list(BRICK),
         input_bytes_factor=halo_bytes(tuple(x.shape), 64) / (x.numel() * 2),
         calls_per_step=1, max_abs_err=err, tol=tol, ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
         library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
         card=card)
    if not err <= tol:
        fail(f"conv3d_k3: error {err} > {tol}")
    record("conv3d_k3", 1, err, ms, plain_ms, b_ms, b_by, lib_ms)
    del x, x_ncdhw, got, want

    # spatial_stats_3d: d0 (fp32), dec (fp32), u (bf16), each on inputs of
    # scale 0.3 (a few rows carry a channel's sums at the temperature 0.01)
    # and 0.01 (every row counts, the kernel's last, shorter slab included).
    # Error relative to each channel's denominator, which bounds
    # |numerators| (|lin| <= 1): a numerator near zero has no relative error
    # of its own. The first (Triton) design is timed beside it (prev_ms).
    l2_evict = torch.zeros(2 ** 27, dtype=torch.float32, device=dev)   # 512 MB

    def flush():   # a read, so that the L2 is left holding clean lines
        l2_evict.sum()

    for v, c, dtype in [(100, 64, torch.float32), (20, 128, torch.float32),
                        (100, 64, torch.bfloat16)]:
        dname = str(dtype).split(".")[1]
        errs, errs_of_den, prev_errs = {}, {}, {}
        for scale in (0.3, 0.01):
            feat = randn(1, v, v, v, c, dtype=dtype, scale=scale)
            cuda_launches = spatial_stats_3d.cuda_launches
            got = spatial_stats_3d(feat)
            want = spatial_stats_3d_plain(feat)
            prev = spatial_stats_3d_triton_prev(feat)
            torch.cuda.synchronize()
            if spatial_stats_3d.cuda_launches != cuda_launches + 1:
                fail(f"spatial_stats_3d {v}^3x{c}: did not launch csrc/spatial_stats.cu")
            den = want[..., :1]
            errs[scale] = (got - want).abs().max().item()
            errs_of_den[scale] = ((got - want).abs() / den).max().item()
            prev_errs[scale] = ((prev - want).abs() / den).max().item()
            if not torch.equal(spatial_stats_3d(feat), got):
                fail(f"spatial_stats_3d {v}^3x{c}: two calls differ (the fold's order)")
        pl = spatial_stats_3d.last_plan
        # the tolerance must reject a kernel that drops its last (shorter) slab
        n_rows = v ** 3
        tail = n_rows - (pl.slabs - 1) * pl.rows_per_slab
        cut = feat.reshape(1, n_rows, c).clone()
        cut[:, n_rows - tail:] = float("-inf")
        tail_err = ((spatial_stats_3d_plain(cut.reshape(feat.shape)) - want).abs()
                    / den).max().item()
        del cut
        ms = median_ms(torch, lambda: spatial_stats_3d(feat), 20)
        prev_ms = median_ms(torch, lambda: spatial_stats_3d_triton_prev(feat), 20)
        plain_ms = median_ms(torch, lambda: spatial_stats_3d_plain(feat), 5)
        dev_ms = profiled_ms(torch, lambda: spatial_stats_3d(feat), 20)
        prev_dev_ms = profiled_ms(torch, lambda: spatial_stats_3d_triton_prev(feat), 20)
        # the same with the L2 evicted before each call (the volume is
        # written by the layer before it on the act step; these calls
        # would otherwise find part of it in L2)
        cold_ms = profiled_ms(torch, lambda: spatial_stats_3d(feat), 20, flush)
        prev_cold_ms = profiled_ms(torch, lambda: spatial_stats_3d_triton_prev(feat), 20,
                                   flush)
        # ~10 fp32 operations an element (sub, mul, exp, 4 adds, 3 muls)
        b_ms, b_by = bound(10.0 * feat.numel(), feat.numel() * feat.element_size()
                           + got.numel() * 4, "float32")
        emit("kernel", name="spatial_stats_3d", shape=[1, v, v, v, c], dtype=dname,
             design="bulk ring" if pl.bulk else "plain loads", slabs=pl.slabs,
             rows_per_slab=pl.rows_per_slab, stage_rows=pl.stage_rows,
             calls_per_step=1, input_scales=list(errs), max_abs_err=max(errs.values()),
             max_err_of_den=list(errs_of_den.values()), tol_of_den=STATS_TOL,
             prev_err_of_den=list(prev_errs.values()), tail_dropped_err_of_den=tail_err,
             ms=ms, prev_ms=prev_ms, plain_ms=plain_ms, device_ms=dev_ms,
             prev_device_ms=prev_dev_ms, cold_l2_device_ms=cold_ms,
             prev_cold_l2_device_ms=prev_cold_ms, library_ms=None, bound_ms=b_ms,
             bound_by=b_by, card=card)
        if not pl.bulk:
            fail(f"spatial_stats_3d {v}^3x{c}: the act step's volume missed the bulk ring")
        if not max(errs_of_den.values()) <= STATS_TOL:
            fail(f"spatial_stats_3d {v}^3x{c} {dname}: error {errs_of_den} "
                 "of the denominator")
        if not tail_err > 10 * STATS_TOL:
            fail(f"spatial_stats_3d {v}^3x{c} {dname}: tolerance does not see "
                 f"the last slab dropped ({tail_err})")
        record("spatial_stats_3d", 1, max(errs.values()), ms, plain_ms, b_ms, b_by,
               None)
        del feat
    del l2_evict

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
            flash_attention.wgmma_launches = conv3d_k3.wgmma_launches = 0
            spatial_stats_3d.cuda_launches = 0
            trace = run_deployment(server, ReplayRobotIO(steps), num_steps=STEPS)
            launches = {c.__name__: c.launches for c in counters}
            launches.update(flash_attention_wgmma=flash_attention.wgmma_launches,
                            conv3d_k3_wgmma=conv3d_k3.wgmma_launches,
                            spatial_stats_3d_cuda=spatial_stats_3d.cuda_launches)
        finally:
            server.act = act
        return trace, times, launches

    trace_on, times_on, launches = drive(server_on)
    per_step = {k: n / STEPS for k, n in launches.items()}
    emit("act", path="kernels", steps=STEPS, p50_ms=statistics.median(times_on),
         step_ms=times_on, launches=launches, launches_per_step=per_step,
         setup_s=setup_s, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=card)
    want_counts = {"flash_attention": 8, "conv3d_k3": 1, "spatial_stats_3d": 3,
                   "flash_attention_wgmma": 8, "conv3d_k3_wgmma": 1,
                   "spatial_stats_3d_cuda": 3}
    if per_step != want_counts:
        fail(f"launches per act step {per_step}, want {want_counts}")
    for name in summary:
        summary[name]["launches"] = launches[name]
    # the kernels line counts the launches of the wgmma/TMA designs and of
    # csrc/spatial_stats.cu
    summary["flash_attention"]["launches"] = launches["flash_attention_wgmma"]
    summary["conv3d_k3"]["launches"] = launches["conv3d_k3_wgmma"]
    summary["spatial_stats_3d"]["launches"] = launches["spatial_stats_3d_cuda"]

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
             stats_kernel_ms=sum(r[1] for r in rows if "stats_kernel" in r[0]),
             device_busy_share=device_ms / wall_ms,
             device_events=sum(r[2] for r in rows),
             top=[{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:15]],
             card=card)

    # ----------------------------------------------------------- 4. render
    packed = render_phase(torch, np, dev, card, out_on[3], vox[0, ..., -1], summary, record)

    # ------------------------------------------------------------ 5. grad
    grad_phase(torch, dev, card, packed)

    # ------------------------------------------------------- 6. summary
    info = {
        "flash_attention": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/flash_attention.cu",
                            "real_robot_nerf_actor_tpu/ops/attention_pallas.py:70"),
        "conv3d_k3": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/conv3d_k3.cu",
                      "real_robot_nerf_actor_tpu/ops/conv3d_pallas.py:46"),
        "spatial_stats_3d": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/spatial_stats.cu",
                             "real_robot_nerf_actor_tpu/ops/stats_pallas.py:59"),
        "corner_lerp": ("triton", "real_robot_nerf_actor_tpu_torch/ops/lerp_cuda.py",
                        "real_robot_nerf_actor_tpu/ops/lerp_pallas.py:59"),
        "ray_expand": ("triton", "real_robot_nerf_actor_tpu_torch/ops/ray_expand_cuda.py",
                       "real_robot_nerf_actor_tpu/ops/ray_expand_pallas.py:98"),
        "fused_resnetfc_int8": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/resnetfc_int8.cu",
                                "real_robot_nerf_actor_tpu/ops/resnetfc_pallas.py:230"),
        "fused_gather_resnetfc_int8": (
            "cuda", "real_robot_nerf_actor_tpu_torch/csrc/resnetfc_int8.cu",
            "real_robot_nerf_actor_tpu/ops/resnetfc_pallas.py:444"),
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
