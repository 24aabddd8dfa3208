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
     spatial_stats_3d lines add the device time with the L2 evicted before
     each call, check that two calls give the same bits, and that the
     tolerance sees the kernel's last slab dropped;
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
     dynamic scales). ray_expand must equal its plain version bit for bit
     (a planted flatT off by one must fail that check) and corner_lerp be
     within one bf16 ulp of it (a dropped corner must fail); their lines add
     the device time (torch.profiler) and the host time of one call without
     a synchronise (host_us). The MLP kernels run their wgmma design, which
     must equal the first (mma.sync) design bit for bit; that design is timed
     beside it (prev_ms). Then FRAME_WARMUP untimed and FRAMES timed frames
     with gather_fused_mlp false (serve.yaml as written) and true: p50 per
     frame, delivered and computed rays/s, active share, peak memory,
     launches per frame (2 per tile for each kernel of the path, every MLP
     launch on the wgmma design, every ray_expand and corner_lerp launch on
     its csrc/ kernel). The frames of the two
     settings must be equal, and the kernel frame must stay within RGB_TOL
     (largest gap) and PSNR_MIN of the plain field's (mlp_backend "xla")
     frame. Three planted glue faults (the fine pass dropped, the field's
     rgb halved, sigma read in ray-major instead of sample-major order)
     must each fail that frame check. Then the field's opt-in modes (see
     proposal_and_quantized_frames): use_proposal on the int8 kernels,
     unfused and gather-fused, against the plain proposal frame at the same
     bound; quantized on the plain path (torch._int_mm) against the plain
     bf16 frame, every quantized layer's outputs against the CPU's on the
     same rows, and a backward through it that must raise. One frame of
     each setting runs under torch.profiler.
  5. grad: forward and backward of the `final` conv (100^3, 128 -> 64,
     bf16) and of corner_lerp (65536 x 512 bf16) with the kernel against
     the plain path (a planted fault each must fail the check), the conv's
     VJP timed alone, then the five kernels without a backward must refuse
     grad and run under no_grad.
  6. train: the PerAct BC train step of configs/peract.yaml at full width
     (see train_phase), conv_backend "conv2d" and "pallas" from the same
     weights, batch and SE(3) draws: step p50, losses, peak memory, launch
     counts (the kernel forward, its wgmma design and the VJP once a step
     with the knob on, never with it off), one profiled step (device time
     split into forward, backward and optimizer); the kernel path's
     gradients against the plain path's within the plain path's own
     bf16-vs-fp32 gap, two planted faults that must fail that check, and
     flash attention and the stats kernel refusing grad in a train step.
  7. nerfact: the NeRF-Actor joint train step of configs/nerfact.yaml at
     full width (see nerfact_phase) in three settings stepping in turns:
     (a) the file as written, (b) the kernels (conv3d_k3 and corner_lerp
     with their VJPs on the corner-expanded grid), (c) (b)'s path with the
     plain versions. Step p50, device time split into forward, render,
     backward and optimizer, device events, peak memory, losses, launch
     counts; (b)'s first-step gradients against (c)'s within (c)'s own
     bf16-vs-fp32 gap, and two planted lerp faults that must fail that
     check. Then b and c with the field's proposal sampler: p50, device
     time, launches, and b's first-step gradients and render loss held to
     c's by the same rule; the coarse embed loss left in must fail it.
  8. replay: training on recorded demos with language (see replay_phase):
     the port writes a multi-kitchen dataset (the 12-layer text tower on
     the card), stages it with multi_replay_data, trains configs/nerfact.yaml
     on it at full width with conv3d_k3, corner_lerp and their VJPs, then
     runs make_multi_replay_eval on a net with every kernel knob on and the
     serving field of configs/serve.yaml (pallas_int8, static scales):
     write and staging time, staged bytes, step p50 and device time,
     losses, every eval metric, launches of all seven kernels in the steps
     and in the eval (counters and profiler kernel names); each of the
     eval's int8 frames against the plain field's render of the same d0
     and draws (the render check's bounds), and a planted wrong pack that
     must fail that check.
  9. featurenerf: FeatureNeRF pretraining (see featurenerf_phase): the port
     writes 8 orbit scenes of 12 views at 128 x 128, dumps the seed-drawn
     ViT-S/8 teacher's features and CLS attention into them, fits a 64-
     component PCA on the card against a float64 SVD, trains
     configs/featurenerf.yaml (its z band overridden) for FNERF_WARMUP +
     FNERF_STEPS steps and one profiled step with three source views, holds
     the first step's losses and gradients on the card to the same step on
     the CPU (two planted faults must fail that check), and evaluates novel
     views of the val scene. No kernel of the seven lies on this path.
 10. bc: behaviour cloning and RL over the representation zoo at full
     width (see bc_phase): BC on resnet50 (fine-tuned and frozen), dino,
     mvp, phase 9's featurenerf encoder and pointnet2; the diffusion head
     and DiffusionQL; SAC on pixels from a prioritized buffer; stored
     episodes into the PerAct step of configs/peract.yaml with conv3d_k3
     and its VJP; the CLIP RN50 dumper. Each part's first update on the
     card is held to the CPU's, and planted faults (BatchNorm statistics
     frozen, TF32 on, SAC's actor gradient in its encoder, a scaled conv3d_k3
     VJP) must fail that.
 11. teacher: the FeatureNeRF contrastive teacher at full width (see
     teacher_phase): 8 scenes of 12 views at 128 x 128 with depth; the
     committed JAX teacher loaded without flax, its features on the card
     against the CPU and its view invariance; the first step on the card
     against the CPU (two planted faults must fail that); TEACHER_STEPS
     steps (p50, device time, the loss falling); the CLI's dump into the
     scenes and one FeatureNeRF step on them; eval/novel.py --out panels
     read back; ConvEncoder and ImplicitNet on the card against the CPU.
 12. camera: the reference's real-camera act path at full width (see
     camera_phase): 8 raw 480 x 640 depth frames of the synthetic scene
     through the RealSense filter chain on the host, then camera-frame and
     world points, the crop, compat.VoxelGrid and phase 3's act step (the
     kernels on) on the card, each piece against the CPU or the plain path,
     with a planted transposed extrinsic; the CNN and VL policy heads, the
     deep 3-D UNet and the augmentations at their users' widths against the
     CPU (two planted faults: symmetric padding, exact GELU); the one-scatter
     grid backward and unsorted compositing at the joint step's shapes;
     tools/profile_policy.py and the kernel build cache.
 13. parallel: configs/nerfact.yaml's joint step in setting b at full width
     over a global batch of two on parallel/ (see parallel_phase): a, the
     wrapped step at world size 1 over NCCL, equal to the bare step, with
     its cost; b, dp 2 and c, tp 2, two ranks on this card over gloo, held
     to a's step by phase 7's gradient rule widened by the CPU's own
     reordering; d, serve.yaml's policy as a tp 2 forward on the flash
     kernel; planted faults (BatchNorm statistics left local, k|v cut
     contiguously, a bias added on both ranks) must fail the legs they
     concern. The two-rank times measure gloo's host staging, not scaling.
 14. checkpoint: the tools that read a trained checkpoint (see
     checkpoint_phase): a kitchen written at full width, configs/nerfact.yaml
     trained on it for CKPT_STEPS steps in setting b, then served through
     train/serve.py --ckpt-dir (logits equal to the trained module's), every
     serving variant of tools/eval_quality.py (each kernel variant's frame
     against its plain field's), tools/analyze_bc.py and
     tools/extract_nerf_feat.py.
 15. envs_forensics: the MuJoCo xArm suite's data on the card and the
     gradient forensics tool (see envs_forensics_phase): the fixture the
     port's envs wrote (tests/fixtures/mujoco_xarm), its episodes into the
     PerAct step of configs/peract.yaml with conv3d_k3 and its VJP (the
     kernels against the plain conv, card against CPU in float64, planted
     faults) and its scenes into the FeatureNeRF step (phase 9's rule);
     where MuJoCo imports, the fixture written again and SAC on live
     pixels, else a line saying "mujoco": "absent"; then
     tools/grad_forensics.py on a
     configs/nerfact.yaml run in setting b: replay from the midway
     checkpoint equal to the run bit for bit, and two planted faults (a
     field weight, a latent attention weight set to inf) located by replay,
     dissect, probe and mint.
It fails (exit code 1, no result line) without a CUDA card, outside a
checkout, or when any phase fails. The last lines are the kernels JSON, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
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
# the train phase: configs/peract.yaml as written (a CPU test holds the two
# equal; the card has no PyYAML)
PERACT = dict(model=dict(depth=6, voxel_size=100, initial_dim=10, num_latents=2048,
                         latent_dim=512, compute_dtype="bfloat16"),
              voxelizer=dict(voxel_size=100, feature_size=3, max_num_coords=220000),
              coord_bounds=[-0.1, -0.3, -0.2, 0.8, 0.7, 0.7], rotation_resolution=5.0,
              trans_aug_range=[0.125, 0.05, 0.05],
              train=dict(num_steps=100000, ckpt_every=10000, log_every=50,
                         optim=dict(lr=1.0e-4, weight_decay=1.0e-6)))
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
# the nerfact phase: configs/nerfact.yaml as written (a CPU test holds the
# two equal)
NERFACT = dict(
    peract=dict(model=dict(depth=6, voxel_size=100, initial_dim=10, num_latents=2048,
                           latent_dim=512, input_encoder="unet", return_voxel_feat=True,
                           compute_dtype="bfloat16"),
                voxelizer=dict(voxel_size=100, feature_size=3, max_num_coords=220000),
                coord_bounds=[-0.1, -0.3, -0.2, 0.8, 0.7, 0.7], se3_symmetric_clamp=True,
                train=dict(num_steps=40000, ckpt_every=2000, eval_every=1000,
                           best_key="bc_render_score",
                           optim=dict(schedule="cosine", warmup_steps=500,
                                      decay_steps=40000))),
    lambda_bc=1.0, lambda_nerf=10.0,
    renderer=dict(image_width=128, image_height=128, z_near=1.2, z_far=4.0, n_coarse=64,
                  n_fine=32, n_fine_depth=16, ray_chunk_size=512, lambda_embed=0.01,
                  lambda_depth=0.1,
                  field=dict(d_latent=64, d_embed=512, d_hidden=512, n_blocks=5,
                             combine_layer=3, compute_dtype="bfloat16",
                             coord_bounds=[-0.1, -0.3, -0.2, 0.8, 0.7, 0.7],
                             mask_outside=True)))
NERFACT_WARMUP = 3
NERFACT_STEPS = 10
# the replay phase: the multi-kitchen dataset the port writes, at the widths
# of configs/nerfact.yaml (128 x 128 views, 512-dim teacher embeds) and the
# writer's 60000 scene points; the grid cut from the reference's 2 kitchens x
# 3 tasks x 5 demos to 2 x 2 x 2 (a task demo has 5 keyframes: the writer
# takes no keyframe count for task demos)
REPLAY_DATA = dict(n_kitchens=2, n_tasks=2, n_demos=2, image_hw=(128, 128), d_embed=512,
                   n_points=60000)
REPLAY_WARMUP = 3
REPLAY_STEPS = 8
# the featurenerf phase: configs/featurenerf.yaml as written (a CPU test holds
# the two equal) and one override: the file's 0.5-1.8 m depth band is for the
# 0.75 m orbit of the JAX package's generate_nerf_scene, while the synthetic
# arc's cameras sit 2.2 m from the scene's centre, outside it; the override is
# FeatureNerfConfig's own default band
FEATURENERF = dict(
    model=dict(d_embed=384, d_hidden=512, n_blocks=5, combine_layer=3, regress_coord=True),
    renderer=dict(n_coarse=64, n_fine=32, n_fine_depth=16, white_bkgd=False),
    ray_batch_size=512, z_near=0.5, z_far=1.8, lambda_coarse=1.0, lambda_fine=1.0,
    lambda_embed=0.1, lambda_attn=0.0, lambda_coord=0.25, nviews=[1],
    train=dict(num_steps=20000, log_every=50, eval_every=1000, ckpt_every=2000,
               optim=dict(lr=1.0e-4)))
FEATURENERF_OVERRIDE = dict(z_near=1.2, z_far=4.0)
# 8 scenes of 12 views at 128 x 128 (the size train/featurenerf.py states for
# a scene; 8 give SceneDataset one val scene), the ViT-S/8 teacher at full
# width, features kept at the teacher's 384 (d_embed of the config)
FNERF_SCENES = dict(n_scenes=8, n_views=12, hw=(128, 128))
FNERF_TEACHER = dict(patch=8, embed_dim=384, depth=12, pca=0)
FNERF_WARMUP = 3
FNERF_STEPS = 10
FNERF_SRC3 = (0, 4, 8)   # the three source views of the combine step and the grad check
# PCA on the card (fp32 covariance and eigh) vs a float64 SVD of the same
# features: each component's projections within PCA_TOL of their largest
# |value| (a CPU run at this width read 9.2e-5 at worst, for a component
# 7.9e-5 of the top eigenvalue from its neighbour; an H100 4.0e-4), the
# explained variances within PCA_VAR_TOL of the top one: the worst-case fp32
# error of a Gram sum over 24576 vectors is 24576 * 2^-24 = 1.5e-3 of its
# scale (the CPU's LAPACK read 3.6e-7, an H100 9.1e-5)
PCA_COMPONENTS = 64
PCA_TOL = 1e-3
PCA_VAR_TOL = 1e-3
# the first step of a trainer on the card against the same step on the CPU
# (fp32, TF32 off, the same weights, inputs and draws; phases 9 and 10):
# losses within LOSS_TOL relative, each gradient within GRAD_TOL of its
# tensor's largest |g| (the two differ only in the order of fp32 sums); where
# a part widens it, plus ULP_K times the largest change that moving every
# weight one ulp (by seeded coins; behind a max-pool, also with the coins
# turned over) makes in that gradient on the CPU: the gradient's own
# sensitivity to rounding (a max over near-ties, a softmax at a low
# temperature), read on the CPU only, so that the card's own rounding never
# sets the card's bound
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
ULP_K = 4
# the trans decoder's bias shifts every trans logit alike, which the softmax
# CE does not see: its gradient is zero, and what a step computes for it is
# rounding
INVARIANT = "trans_decoder.bias"
# the bc phase: BCConfig's defaults (batch 64, MLP head 256, Adam 3e-4) on
# 224 x 224 images, 64 clouds of 4096 points (_stack_obs's cap), SAC on
# make_env's 64 x 64 x 3 pixels at scripts/train_rl.py's batch 128, the CLIP
# dumper on 8 images
BC_BATCH = 64
BC_HW = 224
BC_WARMUP = 2
BC_STEPS = 5
SAC_BATCH = 128
SAC_HW = 64
SAC_UPDATES = 8
CLIP_BATCH = 8
# outputs of a forward on the card within FWD_TOL of the CPU's largest |value|
FWD_TOL = 1e-4
# the teacher phase: 8 orbit scenes of 12 views at 128 x 128 with depth,
# TeacherConfig's defaults (the committed JAX teacher's: d_embed 64, 256
# pairs, Adam 1e-3, encoder (64, 64, 128, 256) x 2 blocks), TEACHER_STEPS
# steps of the CLI's loop; ConvEncoder at its reference width on a batch of
# 8 128 x 128 images; ImplicitNet at pixelNeRF's widths (the positional code
# and viewdirs, 42 wide, into 5 x 512 with a skip at 3) on 8192 points
TEACHER_SCENES = dict(n_scenes=8, n_views=12, hw=(128, 128))
TEACHER_MSGPACK = "artifacts/round5_featurenerf/teacher.msgpack"
TEACHER_STEPS = 1000
CONV_ENCODER_BATCH = 8
IMPLICIT = dict(d_in=42, dims=[512] * 5, d_out=4, skip_in=(3,), points=8192)
# float64 forward and backward on the card against the CPU, of each tensor's
# largest |value| (rounding there is ~1e-16 a step)
F64_TOL = 1e-9
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
# rows of each quantized layer's input held to the CPU (an int32 matmul there)
TWIN_ROWS = 4096
# the camera phase: 8 raw frames of a RealSense D435's 480 x 640 depth stream
# (data/synthetic.py REALSENSE_INTRINSICS, camera_extrinsic) of the synthetic
# scene at 2 M points (about 0.8 of the pixels see one), after CAMERA_WARMUP
# untimed act steps; the models at their users' widths: BC batch 64 of 128 x
# 128 x 3 images, 4 low-dim inputs and CLIP's pooled 512 for the CNN heads;
# serve.yaml's 8000 patch tokens of 128 against CLIP's 77 x 512 tokens for
# the VL transformer (depth 1, 6 heads x 64); the joint step's 100^3 x 64 grid
# at 49152 samples (512 rays x 96) and its 512 rays of 64 + 32 samples
CAMERA = dict(hw=(480, 640), frames=8, n_points=2000000)
CAMERA_WARMUP = 16
CAMERA_MODELS = dict(batch=64, hw=(128, 128), low_dim=4, lang_dim=512,
                     vl_tokens=(8000, 128), lang_tokens=77)
FASTBWD = dict(grid=(1, 100, 100, 100, 64), samples=49152)
COMPOSITE = dict(rays=512, samples=96)
# world points on the card vs the CPU, of their largest |value| (fp32
# products in another order: an ulp is 6e-8)
POINT_TOL = 1e-6
# the camera phase's models in fp32, tensor by tensor: a gradient of fewer
# than SMALL_LEAF entries (biases, norms' affine, a gate, a small head) by
# its largest gap; a larger one by the share of its entries beyond GRAD_TOL
# of its scale plus its slack, at most GRAD_SHARE. A ReLU kink that the
# card's rounding moves across moves every entry of a weight's gradient row
# that it feeds (an H100 moved 90 of SiameseNet's 18,432 conv1 weight
# gradients beyond a bound widened by the CPU's fp32-vs-float64 gap, where
# float64 card and CPU agree to 3e-15); float64 on the card against the
# CPU, every entry within F64_TOL, is the tight check
GRAD_SHARE = 1e-3
SMALL_LEAF = 10 ** 4
# compat.VoxelGrid's grid of those points, card vs CPU: the occupancy equal
# everywhere, and at most VOXEL_DIFF voxels with a channel more than 1e-5
# apart (the scatter's atomics add a voxel's points in another order; a
# point within an ulp of a bin's edge may land in the next bin)
VOXEL_DIFF = 10
# bf16 VL block on the card vs the CPU's bf16, of each tensor's scale, plus
# the CPU's own bf16-vs-fp32 gap at each entry
BF16_FWD = 2 ** -6
BF16_GRAD = 2 ** -5
# the one-scatter grid gradient vs autograd's through grid_sample_3d, of its
# scale: fp32 sums in another order (index_add_'s atomics); in bf16 autograd
# takes the lerp weights in bf16 (each up to 2^-9 off) and rounds every
# corner's product and sum, the fast path weighs in fp32 and rounds once
FASTBWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -5}
# unsorted vs sorted compositing, of each output's scale (a masked matmul
# against a cumsum)
COMPOSITE_TOL = 1e-4


# the parallel phase: configs/nerfact.yaml's joint step in setting b (conv3d_k3
# and corner_lerp with their VJPs) over a global batch of two: the synthetic
# scenes of seeds 0 and 1, so that the two samples' BatchNorm moments differ;
# every bias (and the field's zero-initialised block weights) redrawn at
# PARALLEL_BIAS_STD, so that a bias added on every rank shows. The tp = 2
# forward: serve.yaml's policy with the kernel knobs (phase 3's), its biases at
# POLICY_BIAS_STD, on phase 3's first voxel grid
PARALLEL_BIAS_STD = 0.1
POLICY_BIAS_STD = 1.0
PARALLEL_TIMED = 3
# the fp32 legs (b32, c32): b and c in fp32 under an optimizer whose update
# the clip's global norm reaches: grad_clip 1e-10 puts every clipped entry
# c*g below 1% of Adam's eps (1e-8), so that the first update is lr*c*g/eps,
# linear in the clipped gradient (no entry near zero amplifies a rounding
# gap, as Adam's sign-like regime would), and lr 1 makes it span many ulps
# of its weight. Held against the fp32 one-rank step: the gradients, the
# weights after the step (beyond one ulp of the stored weight, of the
# tensor's largest update), Adam's first moments (the clipped gradient) and
# the loss within FP32_K times the largest gap that the CPU's own fp32
# reordering of the two-rank sums moves the same leg at the dryrun's tiny
# width (4x, as phases 10 and 12 widen by the CPU's own gap), plus ULP_K
# times the tensor's response to a one-ulp move of every weight in the
# one-rank step (phase 10's rule; read from the reference, never from a
# sharded leg). The tiny width has no sum of 10^6 voxels: at full width the
# dp 2 leg (every conv at batch 1, each wgrad summed over a rank's voxels)
# read 3.4% of patchify's weight gradients beyond the CPU's bound alone on an
# H100, where tp 2 (the UNet unsplit) stayed within 0.35 of it. A tensor of
# SMALL_LEAF entries or more is held by the share of its entries beyond its
# bound, at most GRAD_SHARE (phase 12's rule: the policy's amax over 8000
# tokens and 10^6 voxels has near ties that rounding flips, moving a row of
# pos_encoding's gradient: 0.0188 of its scale on an H100); the statistics
# within BN_TOL plus the CPU's gap
PARALLEL32_OPTIM = dict(lr=1.0, grad_clip=1e-10)
FP32_K = 4
PARALLEL_DEADLINE_S = 600
# the tp 2 forward's latents entering the decoder against one rank's: the RMS
# of the gap within LATENT_TOL of the latents' RMS (two bf16 ulps, phase 7's
# floor). The row-parallel partial products are fp32 and round once after
# their sum, as one rank's GEMM rounds once, so the two differ by the order of
# fp32 sums (a bf16 rounding that flips here and there), while a wrong cut
# moves every latent; the logits after the spatial softmax at T = 0.01 hide
# that difference within ACT_TOL (an H100 read 0.099 of the scale for a bias
# added on both ranks, ACT_TOL 0.1)
LATENT_TOL = 2 ** -7
# BatchNorm running statistics of a two-rank step against the one-rank step,
# of their scale: fp32 sums over 10^6 voxels a channel in two halves
BN_TOL = 1e-4
# the checkpoint phase: a kitchen of CKPT_DEMOS demos x CKPT_KEYFRAMES keyframes
# at configs/nerfact.yaml's widths (128 x 128 views, 512-dim teacher embeds, the
# writer's 60000 points), CKPT_STEPS steps of the file in setting b, then the
# tools on the checkpoint
CKPT_DEMOS = 2
CKPT_KEYFRAMES = 3
CKPT_STEPS = 4
# phase 15 (envs_forensics): the fixture tools/gen_data.py wrote with the
# port's MuJoCo envs (its manifest.json lists the commands, the digests and
# the cuts); EPISODE_STEPS bf16 PerAct steps on its episodes; SAC on live
# pixels where MuJoCo imports (the card's machine has none); grad_forensics
# on configs/nerfact.yaml in setting b over a multi-kitchen dataset at its
# widths (128 x 128 views, 512-dim embeds), cut to 2 kitchens x 1 task x 2
# demos, trained FORENSICS_STEPS steps with a checkpoint at FORENSICS_MID
FIXTURE_DIR = "tests/fixtures/mujoco_xarm"
EPISODE_STEPS = 4
EPISODE_DRAWS = [[0.37, -0.61, 0.18]]    # the SE(3) uniforms of every episode step
# the float64 card-vs-CPU pass of the episodes' PerAct step runs at this
# voxel size (the CPU's float64 step at 100^3 takes minutes), and a fault
# confined to the input conv's bias scales its gradient by 1 + BIAS_FAULT
F64_VOXELS = 50
BIAS_FAULT = 1e-6
SAC_LIVE = dict(hw=64, transitions=256, batch=128, updates=4)
FORENSICS_DATA = dict(n_kitchens=2, n_tasks=1, n_demos=2, image_hw=(128, 128), d_embed=512,
                      n_points=60000)
FORENSICS_STEPS = 6
FORENSICS_MID = 3
FIELD_FAULT = ("nerf.mlp_coarse.Dense_0.weight", (0, 0))
ATTN_FAULT = ("policy.self_attn_2.MHAttention_0.to_out.weight", (0, 0))



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


def host_us(torch, fn, reps):
    """Median host time of one call without a synchronise, in us: what the
    host spends to check, allocate and enqueue it (the queue is drained
    before each call, outside the timing)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_rows(torch, prof):
    """(name, device ms, count) of each kernel, copy and set in a profile,
    longest first. The device-side spans of record_function ranges (user
    annotations) are left out: they repeat the time of the kernels inside
    them, gaps included."""
    spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0 and e.key not in spans]
    return sorted(rows, key=lambda r: -r[1])


def range_device_ms(torch, prof, name):
    """Device time of the kernels launched inside the host range `name`."""
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """Deterministic algorithms inside the block (cuDNN's and the index
    ops'; `torch.use_deterministic_algorithms` in warn-only mode), restored
    after. Yields a list that ends up holding the names of the ops that have
    no deterministic version (from their warnings)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    ops = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield ops
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        ops.extend(sorted({str(w.message).split(" does not have")[0][:80]
                           for w in caught if "deterministic" in str(w.message)}))


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
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import (
        corner_lerp, corner_lerp_plain, vector_path)
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
        def expand():
            return ray_expand(tile_rays, z, dims, SERVE_FIELD["coord_bounds"])

        cuda_launches = ray_expand.cuda_launches
        got = expand()
        want = ray_expand_plain(tile_rays, z, dims, SERVE_FIELD["coord_bounds"])
        torch.cuda.synchronize()
        if ray_expand.cuda_launches != cuda_launches + 1:
            fail(f"ray_expand {pass_}: did not launch csrc/ray_expand.cu")
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

        def bit_equal(out):
            return all(torch.equal(a, b) for a, b in zip(out, want))

        if not bit_equal(got):
            fail(f"ray_expand {pass_}: differs from its plain version ({err})")
        # planted: flatT off by one row must fail that check
        if bit_equal((got[0], got[1], got[2] + 1)):
            fail(f"ray_expand {pass_}: the check does not see flatT off by one")
        aux, w8, flat = got[0].reshape(-1, n), got[1].reshape(8, n), got[2].reshape(n)
        ms = median_ms(torch, expand, 20)
        dev_ms = profiled_ms(torch, expand, 20)
        h_us = host_us(torch, expand, 50)
        plain_ms = median_ms(torch, lambda: ray_expand_plain(
            tile_rays, z, dims, SERVE_FIELD["coord_bounds"]), 5)
        nbytes = tile * 8 * 4 + n * 4 + n * (aux.shape[0] * 2 + 8 * 4 + 4)
        b_ms, b_by = bound(120.0 * n, nbytes, "float32")
        emit("kernel", name="ray_expand", route="cuda", shape=[tile, k], dtype="float32",
             calls_per_frame=n_tiles, max_abs_err=err, tol=0.0, flat_off_by_one_fails=True,
             ms=ms, device_ms=dev_ms, host_us=h_us, plain_ms=plain_ms, library_ms=None,
             bound_ms=b_ms, bound_by=b_by, card=card)
        record("ray_expand", n_tiles, err, ms, plain_ms, b_ms, b_by, None)

        # corner_lerp on the gathered rows: one bf16 ulp (<= 2^-7 of each value)
        rows = rows_all[flat.long()]
        cuda_launches = corner_lerp.cuda_launches
        got = corner_lerp(rows, w8)
        want = corner_lerp_plain(rows, w8).float()
        torch.cuda.synchronize()
        if corner_lerp.cuda_launches != cuda_launches + 1:
            fail(f"corner_lerp {pass_}: did not launch csrc/corner_lerp.cu")
        err = (got.float() - want).abs().max().item()
        if not ((got.float() - want).abs() <= 2 ** -7 * want.abs() + 1e-6).all():
            fail(f"corner_lerp {pass_}: more than one bf16 ulp from its plain version")
        no_last = corner_lerp_plain(rows, w8 * torch.tensor([1.0] * 7 + [0.0], device=dev)[:, None])
        if not ((no_last.float() - want).abs() > 2 ** -7 * want.abs() + 1e-6).any():
            fail(f"corner_lerp {pass_}: the check does not see a dropped corner")
        ms = median_ms(torch, lambda: corner_lerp(rows, w8), 20)
        dev_ms = profiled_ms(torch, lambda: corner_lerp(rows, w8), 20)
        h_us = host_us(torch, lambda: corner_lerp(rows, w8), 50)
        plain_ms = median_ms(torch, lambda: corner_lerp_plain(rows, w8), 5)
        rows3, w_lib = rows.view(n, 8, -1), w8.T.unsqueeze(1).to(torch.bfloat16).contiguous()
        lib_ms = median_ms(torch, lambda: torch.bmm(w_lib, rows3), 20)
        nbytes = rows.numel() * 2 + w8.numel() * 4 + got.numel() * 2
        b_ms, b_by = bound(16.0 * got.numel(), nbytes, "float32")
        emit("kernel", name="corner_lerp", route="cuda", shape=list(rows.shape),
             dtype="bfloat16", vector_path=vector_path(rows), calls_per_frame=n_tiles,
             max_abs_err=err, tol="2^-7 of each value", ms=ms, device_ms=dev_ms, host_us=h_us,
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
    cuda_counters = (ray_expand, corner_lerp)
    counters = cuda_counters + mlp_counters

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
        for c in cuda_counters:
            c.cuda_launches = 0
        times = []
        for i in range(FRAMES):
            t = time.perf_counter()
            out = rend.render_image(d0, pose, focal, generator=cuda_gen(seed), occ=occ,
                                    plan=plan)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = {c.__name__: c.launches for c in counters}
        launches.update({f"{c.__name__}_wgmma": c.wgmma_launches for c in mlp_counters})
        launches.update({f"{c.__name__}_cuda": c.cuda_launches for c in cuda_counters})
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
        # every launch of the path on its CUDA kernel: the MLP's on the wgmma
        # design, ray_expand's and corner_lerp's on csrc/
        want = {k: (2 * n_tiles if k.removesuffix("_wgmma").removesuffix("_cuda") in on_path
                    else 0) for k in per_frame}
        if per_frame != want:
            fail(f"render {label}: launches per frame {per_frame}, want {want}")
        for k in on_path:
            if k != "ray_expand" or label == "unfused":
                summary[k]["launches"] = launches[k + ("_wgmma" if k.startswith("fused")
                                                       else "_cuda")]
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
    proposal_and_quantized_frames(torch, dev, card, make, sd, d0, pose, focal, cuda_gen, occ,
                                  plan, n_tiles, frames, rgb_x, frame_check)

    for label, rend in (("unfused", r), ("gather_fused", r_gf)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            rend.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = device_rows(torch, prof)
        device_ms = sum(x[1] for x in rows)
        ranges = {"expand_corners": range_device_ms(torch, prof, "expand_corners")}
        emit("render_profile", gather_fused_mlp=label == "gather_fused",
             frame_wall_ms=wall_ms, device_ms=device_ms,
             device_busy_share=device_ms / wall_ms, ranges_device_ms=ranges,
             device_events=sum(x[2] for x in rows),
             top=[{"name": nm[:80], "ms": ms, "count": c} for nm, ms, c in rows[:15]],
             card=card)
    return r._packed


def proposal_and_quantized_frames(torch, dev, card, make, sd, d0, pose, focal, cuda_gen, occ,
                                  plan, n_tiles, frames, rgb_x, frame_check):
    """Phase 4's two opt-in field modes on the same d0, occupancy and plan.
    (a) use_proposal: the proposal MLP's coarse pass on the plain path, the
    fine pass on the int8 kernels, unfused and gather-fused, each frame
    against the plain field's proposal frame (mlp_backend "xla", on the same
    corner-expanded grid) at the serving bound (RGB_TOL, PSNR_MIN); one
    launch of each kernel of the path a tile. (b) quantized with mlp_backend "xla" (QuantDense, torch._int_mm):
    the frame against the plain bf16 frame at the same bound, and every
    QuantDense output of the first tile against the same layer on the CPU
    from the same input rows: the scales, the int8 codes and the int32
    products are exact on both and the rescale is two fp32 products rounded
    to nearest, so the outputs should agree; the bound is one bf16 ulp at
    the top of each layer's range (2^-8 of its largest |value|), and the
    count of values that differ is reported. (c) A backward through the
    quantized field raises."""
    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.models.resnetfc import QuantDense
    from real_robot_nerf_actor_tpu_torch.ops.quant import quantize_rows

    # (a) the proposal sampler
    r_p = make(use_proposal=True)
    sd_p = random_field_state(torch, r_p, seed=1)
    sd_p.update(sd)                                   # the same full field
    sd_p["mlp_proposal.lin_out_bias"][3] = 1.0
    r_p.load_field(sd_p)
    r_p.calibrate_int8_act(d0, r_p.frame_rays(pose, focal), generator=cuda_gen(3))
    r_pg = make(use_proposal=True, gather_fused_mlp=True)
    r_pg.load_field(sd_p)
    r_pg._int8_act_scales, r_pg._act_scales_t = r_p._int8_act_scales, r_p._act_scales_t
    # the plain field on the same corner-expanded bf16 grid: with the
    # proposal the fine pass composites only the 8 samples that the proposal
    # pass's weights place, so its latent must be the one the kernel renderer
    # samples (on the plain 8-gather fp32 lookup one pixel moved by 0.114 of
    # a frame at 51.9 dB on an H100: a fine sample placed across a bin edge)
    r_px = make(renderer_kw=dict(fused_gather=True), use_proposal=True, mlp_backend="xla")
    r_px.load_field(sd_p)
    rgb_px = r_px.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)[0]
    for label, rend, on_path in (("unfused", r_p, ("ray_expand", "corner_lerp",
                                                   "fused_resnetfc_int8")),
                                 ("gather_fused", r_pg, ("ray_expand",
                                                         "fused_gather_resnetfc_int8"))):
        out, times, launches, peak = frames(rend, 100)
        per_frame = {k: v / FRAMES for k, v in launches.items()}
        want = {k: (n_tiles if k.removesuffix("_wgmma").removesuffix("_cuda") in on_path
                    else 0) for k in per_frame}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            rend.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        device_ms = sum(x[1] for x in device_rows(torch, prof))
        gap = (out[0] - rgb_px).abs().max().item()
        db = -10.0 * math.log10(max(((out[0] - rgb_px) ** 2).mean().item(), 1e-20))
        emit("render_proposal", gather_fused_mlp=label == "gather_fused", frames=FRAMES,
             p50_ms=statistics.median(times), frame_ms=times, launches_per_frame=per_frame,
             profiled_frame_wall_ms=wall_ms, device_ms=device_ms,
             device_busy_share=device_ms / wall_ms, vs_xla_max_rgb_gap=gap, vs_xla_psnr_db=db, rgb_tol=RGB_TOL, psnr_min_db=PSNR_MIN,
             xla_rgb_max=rgb_px.amax().item(), peak_mem_gb=peak, card=card)
        if per_frame != want:
            fail(f"render proposal {label}: launches per frame {per_frame}, want {want}")
        if not (all(torch.isfinite(x).all() for x in out) and gap <= RGB_TOL
                and db >= PSNR_MIN and rgb_px.amax().item() > 0.05):
            fail(f"render proposal {label}: kernel frame vs plain proposal frame, gap {gap}, "
                 f"PSNR {db} dB")
    del r_p, r_pg, r_px

    # (b) the quantized field on the plain path
    r_q = make(quantized=True, mlp_backend="xla")
    r_q.load_field(sd)
    t = time.perf_counter()
    out_q = r_q.render_image(d0, pose, focal, generator=cuda_gen(100), occ=occ, plan=plan)
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t) * 1e3
    gap, db, ok = frame_check(out_q[0])
    layers = [m for m in r_q.field.mlp_coarse.modules() if isinstance(m, QuantDense)]
    seen = []
    hooks = [m.register_forward_hook(lambda mod, a, y: seen.append((mod, a[0], y)))
             for m in layers]
    int_mm_calls = []
    int_mm = torch._int_mm
    torch._int_mm = lambda a, b: (int_mm_calls.append(tuple(a.shape)), int_mm(a, b))[1]
    try:
        with torch.no_grad():
            rays = r_q.frame_rays(pose, focal)[plan.idx[:r_q.cfg.render_tile].clamp(
                max=plan.n_total - 1)]
            r_q.render_rays(d0, rays, cuda_gen(100), occ=occ)
    finally:
        torch._int_mm = int_mm
        for h in hooks:
            h.remove()
    twin_gap, twin_rows, twin_diff, code_diff, scale_diff = 0.0, 0, 0, 0, 0
    for mod, x, y in seen:       # the first TWIN_ROWS rows of each layer's input
        x, y = x[:TWIN_ROWS], y[:TWIN_ROWS]
        cpu = QuantDense(mod.weight.shape[1], mod.weight.shape[0],
                         use_bias=mod.bias is not None, dtype=mod.dtype)
        cpu.load_state_dict({k: v.cpu() for k, v in mod.state_dict().items()})
        with torch.no_grad():
            y_cpu = cpu(x.cpu()).float()
        d = (y.float().cpu() - y_cpu).abs()
        twin_gap = max(twin_gap, (d.max() / y_cpu.abs().max().clamp_min(1e-30)).item())
        twin_rows, twin_diff = twin_rows + x.shape[0], twin_diff + int((d > 0).sum())
        (qc, sc_card), (qh, sc_cpu) = quantize_rows(x), quantize_rows(x.cpu())
        code_diff += int((qc.cpu() != qh).sum())
        scale_diff += int((sc_card.cpu() != sc_cpu).sum())
    # (c) a backward through the quantized field raises
    vox = d0.detach().clone().requires_grad_()
    pts = torch.rand((1, 64, 3), generator=cuda_gen(5), device=dev) * 0.5
    try:
        r_q.field(vox, pts, torch.ones_like(pts))["rgb"].sum().backward()
        backward_raised = False
    except NotImplementedError as e:
        backward_raised = "serving-only" in str(e)
    emit("render_quantized", frame_ms=q_ms, vs_plain_bf16_max_rgb_gap=gap, vs_plain_psnr_db=db,
         rgb_tol=RGB_TOL, psnr_min_db=PSNR_MIN, quant_layers_checked=len(seen),
         int_mm_calls=len(int_mm_calls), int_mm_shapes=sorted(set(int_mm_calls))[:4],
         rows_checked=twin_rows, card_vs_cpu_max_gap_of_scale=twin_gap,
         card_vs_cpu_tol=2 ** -8, card_vs_cpu_values_differing=twin_diff,
         card_vs_cpu_codes_differing=code_diff, card_vs_cpu_row_scales_differing=scale_diff,
         backward_raises=backward_raised, card=card)
    if not ok:
        fail(f"render quantized: frame vs plain bf16 frame, gap {gap}, PSNR {db} dB")
    if not (seen and len(int_mm_calls) == len(seen) and twin_gap <= 2 ** -8):
        fail(f"render quantized: {len(seen)} layers, {len(int_mm_calls)} torch._int_mm calls, "
             f"card vs CPU {twin_gap} (at most 2^-8)")
    if not backward_raised:
        fail("render quantized: a backward through the quantized field did not raise")


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
    torch.backends.cudnn.deterministic = False
    # the VJP alone (cuDNN's data and weight gradients, the bias sum): the
    # backward of `final` on every train step with the kernel
    with torch.no_grad():
        vjp_ms = median_ms(torch, lambda: conv3d_k3_vjp(x, w, g), 10)
        vjp_device_ms = profiled_ms(torch, lambda: conv3d_k3_vjp(x, w, g), 10)
    emit("grad", name="conv3d_k3", shape=[1, 100, 100, 100, 128, 64], dtype="bfloat16",
         gap_of_scale=gaps, tol_of_scale=tols, equals_own_backward=same,
         dk_taps_flipped_gap=flipped, kernel_fwd_bwd_s=kernel_s, vjp_ms=vjp_ms,
         vjp_device_ms=vjp_device_ms, card=card)
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


def train_phase(torch, dev, card):
    """Phase 6: the PerAct BC train step of configs/peract.yaml at full width
    (conv1 encoder, bf16, depth 6, 100^3 x 10 voxels, 2048 x 512 latents,
    220000 padded points, batch 1, AdamW lr 1e-4, weight decay 1e-6),
    weights random from a seeded generator, on one fixed synthetic batch
    and fixed SE(3) draws. conv_backend "conv2d" (the file's setting, the
    plain cuDNN conv) and "pallas" (the k3 kernel forward and its VJP) from
    the same weights: TRAIN_WARMUP untimed and TRAIN_STEPS timed steps each,
    with their launch counts, losses, peak memory and one profiled step.
    The first step's gradients of the kernel path are held per tensor
    against the plain path's, as max |dg| / max |g|, within the gap the
    plain path itself shows between bf16 and fp32 compute (at least 2^-8);
    two planted faults (the kernel's dk zeroed, its taps flipped in the
    forward) must each fail that check. Train steps with flash attention
    or the stats kernel on must refuse grad."""
    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
    from real_robot_nerf_actor_tpu_torch.ops import conv3d_cuda
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    base = from_dict(PerActConfig, PERACT)

    def with_model(**kw):
        return dataclasses.replace(base, model=dataclasses.replace(base.model, **kw))

    t0 = time.perf_counter()
    tr_on = PerActTrainer(with_model(conv_backend="pallas"), device=dev)
    sd_on = {k: v.detach().clone()
             for k, v in tr_on.init_state(torch.Generator().manual_seed(0))
             .module.state_dict().items()}
    sd_off = final_conv_as_plain(sd_on)
    batch = next(tr_on.synthetic_data(batch_size=1, seed=0))
    draws = torch.tensor([[0.37, -0.61, 0.18]], device=dev)
    setup_s = time.perf_counter() - t0

    def fresh(cfg):
        tr = PerActTrainer(cfg, device=dev)
        state = tr.init_state(torch.Generator().manual_seed(0))
        state.module.load_state_dict(sd_on if cfg.model.conv_backend == "pallas" else sd_off)
        return tr, state

    def grads_of(state):
        """The step's gradients by parameter, the plain conv's in the
        kernel's layout and names."""
        g = {n: p.grad.detach().float().clone() for n, p in state.module.named_parameters()}
        if "final.Conv_0.weight" in g:
            g["final.pallas_kernel"] = g.pop("final.Conv_0.weight").permute(2, 3, 4, 1, 0)
            g["final.pallas_bias"] = g.pop("final.Conv_0.bias")
        return g

    def one_step(cfg):
        tr, state = fresh(cfg)
        state, m = tr.train_step(state, batch, draws=draws)
        return grads_of(state), m["loss"].item()

    def profiled(tr, state):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tr.train_step(state, batch, draws=draws)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = device_rows(torch, prof)
        device_ms = sum(r[1] for r in rows)
        split = {k: range_device_ms(torch, prof, f"train_step.{k}")
                 for k in ("forward", "optimizer")}
        # autograd runs the backward on its own thread, outside the range
        split["backward"] = device_ms - split["forward"] - split["optimizer"]
        cpu = torch.autograd.DeviceType.CPU
        ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == cpu
                      and e.self_device_time_total > 0), key=lambda r: -r[1])
        nodes = sorted(((e.key.split(": ")[-1], e.device_time_total / 1e3, e.count)
                        for e in prof.key_averages() if e.device_type == cpu
                        and e.key.startswith("autograd::engine::evaluate_function")),
                       key=lambda r: -r[1])

        def top(rs, n):
            return [{"name": nm[:80], "ms": ms, "count": c} for nm, ms, c in rs[:n]]

        return dict(step_wall_ms=wall_ms, device_ms=device_ms,
                    device_busy_share=device_ms / wall_ms,
                    device_events=sum(r[2] for r in rows), split_device_ms=split,
                    top_kernels=top(rows, 12), top_ops=top(ops, 12),
                    top_backward_nodes=top(nodes, 10))

    # both settings step in turns (A B, B A, ...), so that host noise falls
    # on both p50s alike; the counts are zeroed before and read after each
    # step, and the peak memory is each setting's highest over its steps
    # (the other setting's parameters and AdamW state stay resident)
    runs = {conv: dict(zip(("tr", "state"), fresh(with_model(conv_backend=conv))), times=[],
                       losses=[], peak_gb=0.0, launches=dict.fromkeys(
                           ("conv3d_k3", "conv3d_k3_wgmma", "conv3d_k3_vjp"), 0))
            for conv in ("conv2d", "pallas")}
    torch.cuda.synchronize()
    live_gb = torch.cuda.memory_allocated() / 2 ** 30
    n = TRAIN_WARMUP + TRAIN_STEPS
    for i in range(n):
        for conv in (("conv2d", "pallas") if i % 2 == 0 else ("pallas", "conv2d")):
            r = runs[conv]
            torch.cuda.reset_peak_memory_stats()
            conv3d_k3.launches = conv3d_k3.wgmma_launches = conv3d_k3.vjp_calls = 0
            t = time.perf_counter()
            r["state"], m = r["tr"].train_step(r["state"], batch, draws=draws)
            torch.cuda.synchronize()
            if i >= TRAIN_WARMUP:
                r["times"].append((time.perf_counter() - t) * 1e3)
            for k, v in (("conv3d_k3", conv3d_k3.launches),
                         ("conv3d_k3_wgmma", conv3d_k3.wgmma_launches),
                         ("conv3d_k3_vjp", conv3d_k3.vjp_calls)):
                r["launches"][k] += v
            r["peak_gb"] = max(r["peak_gb"], torch.cuda.max_memory_allocated() / 2 ** 30)
            r["losses"].append(m["loss"].item())
            if i == 0:
                r["grads"] = grads_of(r["state"])
    for conv, r in runs.items():
        times, losses, launches = r["times"], r["losses"], r["launches"]
        emit("train", conv_backend=conv, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
             p50_ms=statistics.median(times), step_ms=times, loss_first=losses[0],
             loss_last=losses[-1], losses=losses, launches=launches,
             launches_per_step={k: v / n for k, v in launches.items()},
             peak_mem_gb=r["peak_gb"], live_before_gb=live_gb, setup_s=setup_s,
             **profiled(r["tr"], r["state"]), card=card)
        want = n if conv == "pallas" else 0
        if launches != {k: want for k in launches}:
            fail(f"train {conv}: launches {launches} over {n} steps, want {want} of each")
        if not all(map(math.isfinite, losses)):
            fail(f"train {conv}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"train {conv}: the loss on the fixed batch did not fall: {losses}")
        del r["tr"], r["state"]

    def gaps(got, want):
        return {n: ((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                for n, w in want.items() if n != INVARIANT}

    # the tolerance: what bf16 compute itself moves each gradient on the
    # plain path, against the same step in fp32
    g_fp32, loss_fp32 = one_step(with_model(compute_dtype="float32"))
    plain = runs["conv2d"]["grads"]
    tol = {n: max(v, 2 ** -8) for n, v in gaps(plain, g_fp32).items()}
    del g_fp32

    def check(got):
        """(worst gap / tolerance and its tensor, gaps of `final`)."""
        g = gaps(got, plain)
        worst = max(g, key=lambda n: g[n] / tol[n])
        return g[worst] / tol[worst], worst, {n: g[n] for n in g if n.startswith("final.")}

    ratio, worst, final_gaps = check(runs["pallas"]["grads"])
    launch = conv3d_cuda._launch
    vjp = conv3d_cuda.conv3d_k3_vjp
    faults = {}
    try:
        conv3d_cuda.conv3d_k3_vjp = lambda *a: (lambda dx, dk, db: (dx, torch.zeros_like(dk),
                                                                  db))(*vjp(*a))
        faults["dk_zeroed"] = check(one_step(with_model(conv_backend="pallas"))[0])
        conv3d_cuda.conv3d_k3_vjp = vjp
        conv3d_cuda._launch = lambda x, k, b: launch(x, k.flip(0, 1, 2).contiguous(), b)
        faults["taps_flipped"] = check(one_step(with_model(conv_backend="pallas"))[0])
    finally:
        conv3d_cuda._launch, conv3d_cuda.conv3d_k3_vjp = launch, vjp

    refused = {}
    for knob, name in (({"use_flash_attention": True}, "flash_attention"),
                       ({"stats_backend": "pallas"}, "spatial_stats_3d")):
        tr, state = fresh(with_model(**knob))
        try:
            tr.train_step(state, batch, draws=draws)
            refused[name] = False
        except RuntimeError as e:
            refused[name] = name in str(e) and "requires a gradient" in str(e)
        del tr, state
    emit("train_grad", tensors=len(tol), worst_gap_over_tol=ratio, worst_tensor=worst,
         worst_gap=ratio * tol[worst], worst_tol=tol[worst], final_gaps=final_gaps,
         plain_bf16_vs_fp32_gap={"max": max(tol.values()),
                                 "median": statistics.median(tol.values()),
                                 "final": {n: tol[n] for n in final_gaps}},
         loss_fp32=loss_fp32, loss_bf16=runs["conv2d"]["losses"][0],
         planted_faults={k: {"worst_gap_over_tol": r, "worst_tensor": n, "final_gaps": f}
                         for k, (r, n, f) in faults.items()},
         refused_under_grad=refused, card=card)
    if not ratio <= 1.0:
        fail(f"train: the kernel path's gradient of {worst} is {ratio} x its tolerance")
    for k, (r, n, _) in faults.items():
        if not r > 1.0:
            fail(f"train: the gradient check does not see the planted fault {k} ({r})")
    if not all(refused.values()):
        fail(f"train: a kernel without a backward did not refuse grad: {refused}")


def nerfact_phase(torch, dev, card):
    """Phase 7: the NeRF-Actor joint train step of configs/nerfact.yaml at
    full width (UNet encoder with BatchNorm in train mode, bf16 policy,
    depth 6, 100^3 x 10 voxels, 2048 x 512 latents, 220000 padded points,
    batch 1; 512 rays of 64 + 32 samples (16 of them around the coarse
    depth) on a 128 x 128 view, field 64 -> 5 x 512 bf16 with
    mask_outside; lambda_nerf 10, lambda_embed 0.01; AdamW on the cosine
    schedule with 500 warmup steps), weights random from a seeded
    generator, one synthetic batch with its view and gt_embed, fixed SE(3)
    and render draws. Settings, from the same weights, NERFACT_WARMUP
    untimed and NERFACT_STEPS timed steps each, in turns:
      a: the file as written: conv2d, fused_gather "auto" (8 gathers a
         sample at 49152 samples), no kernel;
      b: kernels: conv_backend "pallas" (conv3d_k3 forward and VJP),
         fused_gather true and FUSED_LERP_BACKEND "pallas" (corner_lerp
         and its VJP, one a pass);
      c: b's corner-expanded path with the kernels' plain versions:
         conv2d with final_conv_as_plain weights, and the lerp's plain
         version (lerp_cuda.corner_lerp_plain, autograd as its backward)
         in place of the kernel on the same "pallas" route. The "xla"
         route's nested lerp rounds the weights and every lerp stage to
         bf16, so its field gradients carry other bf16 noise than the
         kernel's one rounding of an fp32 sum: on an H100 b stood up to
         2.07x c's own bf16-vs-fp32 gap from c on that route, and as far
         from the fp32 step.
    Fails unless b launches the conv forward (wgmma) and its VJP once a
    step and the lerp and its VJP twice, a and c neither; loss_total falls
    and every BatchNorm running statistic moved after step 1 in every
    setting; b's first-step gradients, tensor by tensor and with the
    rendering loss's gradient of d0 as one more tensor, lie within c's own
    bf16-vs-fp32 gap (at least 2^-7, two bf16 ulps: see the tolerance
    below), and two planted faults each fail that check: the lerp's d_rows
    zeroed, and corner weights 0 and 1 swapped in the kernel's forward."""
    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
    from real_robot_nerf_actor_tpu_torch.ops import grid_sample, lerp_cuda
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    base = from_dict(NerfActConfig, NERFACT)

    def setting(name, fp32=False, proposal=False):
        """(config, FUSED_LERP_BACKEND, the lerp it calls) of setting a, b
        or c; with proposal, the field's proposal sampler on."""
        conv, expand, lerp, fn = {
            "a": ("conv2d", "auto", "xla", corner_lerp),
            "b": ("pallas", True, "pallas", corner_lerp),
            "c": ("conv2d", True, "pallas", lerp_cuda.corner_lerp_plain)}[name]
        model = dataclasses.replace(base.peract.model, conv_backend=conv)
        field = dataclasses.replace(base.renderer.field, use_proposal=proposal)
        if fp32:
            model = dataclasses.replace(model, compute_dtype="float32")
            field = dataclasses.replace(field, compute_dtype="float32")
        return dataclasses.replace(
            base, peract=dataclasses.replace(base.peract, model=model),
            renderer=dataclasses.replace(base.renderer, fused_gather=expand,
                                         field=field)), lerp, fn

    t0 = time.perf_counter()
    cfg_b = setting("b")[0]
    tr_b = NerfActTrainer(cfg_b, device=dev)
    sd_b = {k: v.detach().clone() for k, v in tr_b.init_state(
        torch.Generator().manual_seed(0)).module.state_dict().items()}
    sd_plain = final_conv_as_plain(sd_b, "policy.")
    batch = next(tr_b.synthetic_data(batch_size=1, seed=0))
    g = torch.Generator().manual_seed(1)
    r, rc = cfg_b.renderer.ray_chunk_size, cfg_b.renderer
    nf = rc.n_fine - rc.n_fine_depth
    draws = dict(draws=torch.tensor([[0.37, -0.61, 0.18]], device=dev),
                 ray_idx=torch.randint(0, rc.image_height * rc.image_width, (r,),
                                       generator=g).to(dev),
                 render_draws={k: v.to(dev) for k, v in (
                     ("coarse_u", torch.rand((r, rc.n_coarse), generator=g)),
                     ("fine_u", torch.rand((r, nf), generator=g)),
                     ("fine_jitter", torch.rand((r, nf), generator=g)),
                     ("fine_depth_eps", torch.randn((r, rc.n_fine_depth), generator=g)))})
    # the proposal part's batch: unit-scale teacher features (the synthetic
    # batch's are 0.01 of that), so that an embed term shows in the loss
    batch_p = dict(batch, gt_embed=torch.randn(batch["gt_embed"].shape,
                                               generator=torch.Generator().manual_seed(2)
                                               ).to(dev))
    setup_s = time.perf_counter() - t0

    sd_proposal = {}

    def fresh(name, fp32=False, proposal=False, coarse_embed_fault=False):
        cfg, lerp, fn = setting(name, fp32, proposal)
        tr = NerfActTrainer(cfg, device=dev)
        state = tr.init_state(torch.Generator().manual_seed(0))
        sd = sd_b if name == "b" else sd_plain
        if proposal:    # the proposal MLP's weights: one draw for every run
            if not sd_proposal:
                sd_proposal.update({k: v.detach().clone() for k, v in state.module.state_dict(
                    ).items() if k.startswith("nerf.mlp_proposal.")})
            sd = dict(sd, **sd_proposal)
        state.module.load_state_dict(sd)
        # the rendering loss's own gradient of d0: the slice handed to it
        inner = tr.renderer.rendering_loss

        def rendering_loss(voxel_feat, *a, **k):
            voxel_feat.retain_grad()
            tr.voxel_feat = voxel_feat
            loss, m = inner(voxel_feat, *a, **k)
            if coarse_embed_fault:
                # planted: the coarse embed term the proposal mode drops,
                # left in (the proposal pass's embed is zero)
                gt_e = k["gt_embed"].reshape(-1, k["gt_embed"].shape[-1])[k["ray_idx"]]
                m["loss_embed_coarse"] = cfg.renderer.lambda_embed * (gt_e ** 2).mean()
                loss = loss + m["loss_embed_coarse"]
                m["loss_render"] = loss
            return loss, m

        tr.renderer.rendering_loss = rendering_loss
        return dict(tr=tr, state=state, lerp=lerp, lerp_fn=fn, batch=batch)

    def route(run):
        """The run's lerp route: the expanded path calls
        lerp_cuda.corner_lerp, which c replaces by its plain version."""
        grid_sample.FUSED_LERP_BACKEND = run["lerp"]
        lerp_cuda.corner_lerp = run["lerp_fn"]

    def step(run):
        route(run)
        return run["tr"].train_step(run["state"], run["batch"], **draws)[1]

    def grads_of(run):
        """The step's gradients by parameter (the plain conv's in the
        kernel's layout and names), and the rendering loss's gradient of
        d0 as `render.d_voxel_feat`."""
        grads = {n: p.grad.detach().float().clone()
                 for n, p in run["state"].module.named_parameters()}
        if "policy.final.Conv_0.weight" in grads:
            grads["policy.final.pallas_kernel"] = grads.pop(
                "policy.final.Conv_0.weight").permute(2, 3, 4, 1, 0)
            grads["policy.final.pallas_bias"] = grads.pop("policy.final.Conv_0.bias")
        grads["render.d_voxel_feat"] = run["tr"].voxel_feat.grad.float().clone()
        return grads

    def one_step(name, fp32=False, **kw):
        run = fresh(name, fp32, **kw)
        if kw.get("proposal"):
            run["batch"] = batch_p
        m = step(run)
        return grads_of(run), m["loss_total"].item(), {k: v.item() for k, v in m.items()}

    def profiled(run):
        route(run)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run["tr"].train_step(run["state"], run["batch"], **draws)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = device_rows(torch, prof)
        device_ms = sum(x[1] for x in rows)
        split = {k: range_device_ms(torch, prof, f"train_step.{k}")
                 for k in ("forward", "render", "optimizer")}
        # autograd runs the backward on its own thread, outside the range
        split["backward"] = device_ms - split["forward"] - split["render"] - split["optimizer"]
        lerp_rows = [x for x in rows if "lerp_vector" in x[0] or "lerp_scalar" in x[0]]
        return dict(step_wall_ms=wall_ms, device_ms=device_ms,
                    device_busy_share=device_ms / wall_ms,
                    device_events=sum(x[2] for x in rows), split_device_ms=split,
                    corner_lerp_device_ms=[{"name": n[:60], "ms": ms, "count": c}
                                           for n, ms, c in lerp_rows],
                    top_kernels=[{"name": n[:80], "ms": ms, "count": c}
                                 for n, ms, c in rows[:12]])

    counters = (("conv3d_k3", conv3d_k3, "launches"), ("conv3d_k3_wgmma", conv3d_k3,
                                                       "wgmma_launches"),
                ("conv3d_k3_vjp", conv3d_k3, "vjp_calls"),
                ("corner_lerp", corner_lerp, "cuda_launches"),
                ("corner_lerp_vjp", corner_lerp, "vjp_calls"))
    runs = {name: dict(fresh(name), times=[], losses=[], peak_gb=0.0,
                       launches=dict.fromkeys((c[0] for c in counters), 0))
            for name in "abc"}
    bn_before = {n: b.clone() for n, b in runs["a"]["state"].module.named_buffers()}
    torch.cuda.synchronize()
    live_gb = torch.cuda.memory_allocated() / 2 ** 30
    n = NERFACT_WARMUP + NERFACT_STEPS
    for i in range(n):
        for name in ("abc" if i % 2 == 0 else "cba"):
            run = runs[name]
            torch.cuda.reset_peak_memory_stats()
            for _, obj, attr in counters:
                setattr(obj, attr, 0)
            t = time.perf_counter()
            m = step(run)
            torch.cuda.synchronize()
            if i >= NERFACT_WARMUP:
                run["times"].append((time.perf_counter() - t) * 1e3)
            for key, obj, attr in counters:
                run["launches"][key] += getattr(obj, attr)
            run["peak_gb"] = max(run["peak_gb"], torch.cuda.max_memory_allocated() / 2 ** 30)
            run["losses"].append(m["loss_total"].item())
            if i == 0:
                run["metrics"] = {k: v.item() for k, v in m.items()}
                run["bn_moved"] = all(
                    not torch.equal(b, bn_before[k])
                    for k, b in run["state"].module.named_buffers())
    per_step = {"a": 0, "b": 1, "c": 0}
    for name, run in runs.items():
        times, losses, launches = run["times"], run["losses"], run["launches"]
        want = {k: n * per_step[name] * (2 if k.startswith("corner_lerp") else 1)
                for k in launches}
        emit("nerfact", setting=name, config=dict(
                 conv_backend=run["tr"].cfg.model.conv_backend,
                 fused_gather=run["tr"].jcfg.renderer.fused_gather,
                 fused_lerp_backend=run["lerp"], lerp=run["lerp_fn"].__name__),
             warmup=NERFACT_WARMUP, steps=NERFACT_STEPS, p50_ms=statistics.median(times),
             step_ms=times, loss_first=losses[0], loss_last=losses[-1], losses=losses,
             first_step_metrics=run["metrics"], bn_stats_moved_after_step_1=run["bn_moved"],
             launches=launches, launches_per_step={k: v / n for k, v in launches.items()},
             peak_mem_gb=run["peak_gb"], live_before_gb=live_gb, setup_s=setup_s,
             **profiled(run), card=card)
        if launches != want:
            fail(f"nerfact {name}: launches {launches} over {n} steps, want {want}")
        if not all(map(math.isfinite, losses)):
            fail(f"nerfact {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"nerfact {name}: loss_total on the fixed batch did not fall: {losses}")
        if not run["bn_moved"]:
            fail(f"nerfact {name}: a BatchNorm running statistic did not move in step 1")
    grid_sample.FUSED_LERP_BACKEND, lerp_cuda.corner_lerp = "xla", corner_lerp

    # the lerp and its VJP alone at this path's shapes (the coarse pass's
    # 512 x 64 samples, the fine pass's 512 x 32), bf16 rows of the
    # expanded 64-channel grid; bound: the rows (1024 B), w (32 B) and the
    # output (128 B) of a row once at 3.35 TB/s
    lerp_gen = torch.Generator(device=dev).manual_seed(7)
    for m_rows in (r * rc.n_coarse, r * rc.n_fine):
        rows = torch.randn((m_rows, 512), generator=lerp_gen, device=dev).to(torch.bfloat16)
        w8 = torch.rand((8, m_rows), generator=lerp_gen, device=dev)
        g_out = torch.randn((m_rows, 64), generator=lerp_gen, device=dev).to(torch.bfloat16)
        # the library call of the render phase's lerp line: one batched matmul
        rows3, w_lib = rows.view(m_rows, 8, -1), w8.T.unsqueeze(1).to(torch.bfloat16).contiguous()
        with torch.no_grad():
            err = (corner_lerp(rows, w8).float()
                   - lerp_cuda.corner_lerp_plain(rows, w8).float()).abs().max().item()
            b_ms, b_by = bound(15.0 * m_rows * 64, m_rows * (1024 + 32 + 128), "float32")
            emit("nerfact_lerp", shape=[m_rows, 512], dtype="bfloat16", max_abs_err=err,
                 ms=median_ms(torch, lambda: corner_lerp(rows, w8), 20),
                 device_ms=profiled_ms(torch, lambda: corner_lerp(rows, w8), 20),
                 plain_ms=median_ms(torch, lambda: lerp_cuda.corner_lerp_plain(rows, w8), 20),
                 library_ms=median_ms(torch, lambda: torch.bmm(w_lib, rows3), 20),
                 vjp_ms=median_ms(torch, lambda: lerp_cuda.corner_lerp_vjp(rows, w8, g_out), 20),
                 vjp_device_ms=profiled_ms(
                     torch, lambda: lerp_cuda.corner_lerp_vjp(rows, w8, g_out), 20),
                 bound_ms=b_ms, bound_by=b_by, card=card)
    del rows, w8, g_out, rows3, w_lib

    loss_bf16 = runs["c"]["losses"][0]
    for run in runs.values():
        del run["tr"], run["state"]
    del runs

    def gaps(got, want):
        return {k: ((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                for k, w in want.items() if k != "policy." + INVARIANT}

    # The check's steps run with deterministic algorithms (cuDNN's and the
    # index ops'; a warning where an op has none, counted below): with the
    # default ones their atomics move the bf16 gradients from one run to
    # the next, and the worst tensor read 0.65, 0.82 and 1.71 of its
    # tolerance over three runs of this phase in one process on an H100, a
    # draw rather than a comparison of the two paths. Each setting's first
    # step is taken again from a fresh state, as in the loop above.
    with deterministic_algorithms(torch) as nondeterministic_ops:
        grads = {name: one_step(name)[0] for name in "bc"}
        # the tolerance: what bf16 compute itself moves each gradient on
        # c's path, against the same step in fp32, and at least two bf16
        # ulps of the tensor's scale: b and c round `final`'s output each
        # once (the kernel, cuDNN), so one voxel can be two ulps apart,
        # and a gradient that one voxel dominates (trans_decoder's weight:
        # the label voxel) moves by as much (1.045 ulps in one H100 run,
        # where c's own gap was under one)
        g_fp32, loss_fp32, _ = one_step("c", fp32=True)
        tol = {k: max(v, 2 ** -7) for k, v in gaps(grads["c"], g_fp32).items()}
        # b's own gap to the fp32 step, beside c's: how far each bf16 path lies
        b_fp32 = gaps(grads["b"], g_fp32)
        b_fp32_worst = max(b_fp32, key=lambda k: b_fp32[k] / tol[k])
        del g_fp32

        def check(got):
            """(worst gap / tolerance, its tensor, the gaps of the render
            gradient of d0 and of the field's first layer)."""
            gp = gaps(got, grads["c"])
            worst = max(gp, key=lambda k: gp[k] / tol[k])
            return gp[worst] / tol[worst], worst, {
                k: gp[k] for k in ("render.d_voxel_feat", "nerf.mlp_coarse.lin_z_0.weight",
                                   "policy.final.pallas_kernel")}

        ratio, worst, named_gaps = check(grads["b"])
        # b's first step taken once more: zero if the steps reproduce
        repeat = max(gaps(one_step("b")[0], grads["b"]).values())
        vjp, launch = lerp_cuda.corner_lerp_vjp, lerp_cuda._launch
        faults = {}
        try:
            lerp_cuda.corner_lerp_vjp = lambda *a: (lambda d_rows, d_w: (
                torch.zeros_like(d_rows), d_w))(*vjp(*a))
            faults["d_rows_zeroed"] = check(one_step("b")[0])
            lerp_cuda.corner_lerp_vjp = vjp
            swap = [1, 0, 2, 3, 4, 5, 6, 7]
            lerp_cuda._launch = lambda rows, w: launch(rows, w[swap].contiguous())
            faults["corners_0_1_swapped"] = check(one_step("b")[0])
        finally:
            lerp_cuda.corner_lerp_vjp, lerp_cuda._launch = vjp, launch
            grid_sample.FUSED_LERP_BACKEND, lerp_cuda.corner_lerp = "xla", corner_lerp
    emit("nerfact_grad", tensors=len(tol), worst_gap_over_tol=ratio, worst_tensor=worst,
         worst_gap=ratio * tol[worst], worst_tol=tol[worst], gaps=named_gaps,
         repeat_max_gap=repeat, nondeterministic_ops=nondeterministic_ops,
         plain_bf16_vs_fp32_gap={"max": max(tol.values()),
                                 "median": statistics.median(tol.values()),
                                 "named": {k: tol[k] for k in named_gaps}},
         kernel_vs_fp32={"worst_gap_over_tol": b_fp32[b_fp32_worst] / tol[b_fp32_worst],
                         "worst_tensor": b_fp32_worst,
                         "named": {k: b_fp32[k] for k in named_gaps}},
         loss_fp32=loss_fp32, loss_bf16=loss_bf16,
         planted_faults={k: {"worst_gap_over_tol": x, "worst_tensor": t, "gaps": f}
                         for k, (x, t, f) in faults.items()}, card=card)
    if not ratio <= 1.0:
        fail(f"nerfact: the kernel path's gradient of {worst} is {ratio} x its tolerance")
    for k, (x, _, _) in faults.items():
        if not x > 1.0:
            fail(f"nerfact: the gradient check does not see the planted fault {k} ({x})")

    # ---- the proposal sampler (field.use_proposal: true) in settings b and
    # c: the coarse pass on the proposal MLP (the lerp kernel where the
    # latent is sampled), the fine pass compositing the new samples only
    prop = {}
    for name in "bc":
        prop[name] = dict(fresh(name, proposal=True), times=[], losses=[],
                          launches=dict.fromkeys((c[0] for c in counters), 0))
        prop[name]["batch"] = batch_p
    for i in range(n):
        for name in ("bc" if i % 2 == 0 else "cb"):
            run = prop[name]
            for _, obj, attr in counters:
                setattr(obj, attr, 0)
            t = time.perf_counter()
            m = step(run)
            torch.cuda.synchronize()
            if i >= NERFACT_WARMUP:
                run["times"].append((time.perf_counter() - t) * 1e3)
            for key, obj, attr in counters:
                run["launches"][key] += getattr(obj, attr)
            run["losses"].append(m["loss_total"].item())
    for name, run in prop.items():
        losses, launches = run["losses"], run["launches"]
        want = {k: n * per_step[name] * (2 if k.startswith("corner_lerp") else 1)
                for k in launches}
        emit("nerfact_proposal", setting=name, warmup=NERFACT_WARMUP, steps=NERFACT_STEPS,
             p50_ms=statistics.median(run["times"]), step_ms=run["times"],
             loss_first=losses[0], loss_last=losses[-1], launches=launches,
             launches_per_step={k: v / n for k, v in launches.items()}, **profiled(run),
             card=card)
        if launches != want:
            fail(f"nerfact proposal {name}: launches {launches} over {n} steps, want {want}")
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail(f"nerfact proposal {name}: loss_total did not fall: {losses}")
    del prop, run
    with deterministic_algorithms(torch):
        g_b, _, m_b = one_step("b", proposal=True)
        g_c, _, m_c = one_step("c", proposal=True)
        g_f, _, m_f = one_step("c", fp32=True, proposal=True)
        tol_p = {k: max(v, 2 ** -7) for k, v in gaps(g_c, g_f).items()}
        # the render loss by the same rule: c's own bf16-vs-fp32 gap, at
        # least 2^-7 relative
        loss_tol = max(abs(m_c["loss_render"] - m_f["loss_render"]) / abs(m_f["loss_render"]),
                       2 ** -7)
        del g_f

        def check_p(got, m):
            """(worst of the gradients' and the render loss's gap over its
            tolerance, the worst tensor, the loss gap, the metric names
            equal to c's)."""
            gp = gaps(got, g_c)
            worst = max(gp, key=lambda k: gp[k] / tol_p[k])
            loss_gap = abs(m["loss_render"] - m_c["loss_render"]) / abs(m_c["loss_render"])
            return (max(gp[worst] / tol_p[worst], loss_gap / loss_tol), worst, loss_gap,
                    set(m) == set(m_c))

        ratio_p, worst_p, loss_gap_p, keys_p = check_p(g_b, m_b)
        g_fault, _, m_fault = one_step("b", proposal=True, coarse_embed_fault=True)
        fault_p = check_p(g_fault, m_fault)
        del g_b, g_fault
    grid_sample.FUSED_LERP_BACKEND, lerp_cuda.corner_lerp = "xla", corner_lerp
    emit("nerfact_proposal_grad", tensors=len(tol_p), worst_gap_over_tol=ratio_p,
         worst_tensor=worst_p, loss_render_gap=loss_gap_p, loss_render_tol=loss_tol,
         metric_names_equal=keys_p, metrics_b=m_b, metrics_c=m_c,
         plain_bf16_vs_fp32_gap={"max": max(tol_p.values()),
                                 "median": statistics.median(tol_p.values())},
         planted_faults={"coarse_embed_loss_left_in": {
             "worst_gap_over_tol": fault_p[0], "worst_tensor": fault_p[1],
             "loss_render_gap": fault_p[2], "metric_names_equal": fault_p[3]}}, card=card)
    if "loss_embed_coarse" in m_c or not keys_p or not ratio_p <= 1.0:
        fail(f"nerfact proposal: the kernel path is {ratio_p} x its tolerance ({worst_p}), "
             f"metric names equal: {keys_p}")
    if fault_p[0] <= 1.0 and fault_p[3]:
        fail(f"nerfact proposal: the check does not see the coarse embed loss left in "
             f"({fault_p})")


# the seven kernels by their CUDA function names in a profile
KERNEL_NAMES = {"flash_attention": ("flash_fwd_wgmma", "flash_fwd_simt"),
                "conv3d_k3": ("conv3d_k3_wgmma", "conv3d_k3_simt"),
                "spatial_stats_3d": ("stats_kernel",),
                "corner_lerp": ("lerp_vector", "lerp_scalar"),
                "ray_expand": ("ray_expand_kernel",),
                "fused_resnetfc_int8": ("resnetfc_wgmma<false", "resnetfc_kernel<false"),
                "fused_gather_resnetfc_int8": ("resnetfc_wgmma<true", "resnetfc_kernel<true")}


def kernel_counts(prof):
    """Launches of each of the seven kernels in a profile, by kernel name."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for e in prof.key_averages():
        for name, keys in KERNEL_NAMES.items():
            if any(k in e.key for k in keys):
                counts[name] += e.count
    return counts


def replay_phase(torch, dev, card):
    """Phase 8: training on recorded demos with language, at full width.

    1. The port's write_multi_kitchen_dataset writes REPLAY_DATA into a
       temporary directory (the text tower of 12 layers x 512 on the card).
    2. NerfActTrainer on configs/nerfact.yaml as written (UNet encoder in
       train mode, bf16, 100^3, 2048 x 512 latents, depth 6, 512 rays of
       64 + 32 samples) with conv_backend "pallas" and fused_gather true on
       FUSED_LERP_BACKEND "pallas"; the field's weights random from a seed
       (std fan_in^-1/2, density bias 1, so the frames are not empty).
       multi_replay_data (uniform) stages every cloud and view on the card;
       REPLAY_WARMUP untimed steps, REPLAY_STEPS timed ones, one more under
       the profiler. The staged labels are computed on the card, as the JAX
       package computes them on its device: their count of rows that differ
       from the CPU's is reported, not held to a bound. The same steps are
       then taken again from the same seed on deterministic algorithms:
       those weights, and the eval on deterministic algorithms, make the
       eval's numbers reproduce from run to run.
    3. make_multi_replay_eval, once, on a net loaded with the trained
       weights that has every kernel knob on (use_flash_attention,
       conv_backend and stats_backend "pallas") and the field of
       configs/serve.yaml (pallas_int8, static scales calibrated per
       kitchen, gather_fused_mlp false): under the profiler. Each of its
       frames is rendered again by the plain field ("xla", 8 gathers) from
       the same d0 and draws, and must lie within RGB_TOL / PSNR_MIN of it.
       One render_eval with gather_fused_mlp true (kernel 7), which must
       equal the same render_eval on kernel 6 (its distance to the plain
       field is reported), and one whose kernel pack comes from a field
       drawn from another seed (what a stale pack gives after a checkpoint
       load), which must fail the frame check.
    Fails on a non-finite loss, on a kernel of the path that launched no
    time (wrapper counters and profiler names), on a failed frame check,
    and on a planted fault that passes it."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.data.kitchen import write_multi_kitchen_dataset
    from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
    from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource
    from real_robot_nerf_actor_tpu_torch.ops import grid_sample
    from real_robot_nerf_actor_tpu_torch.ops.action_codec import discretize_action
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.geometry import point_to_voxel_index
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    from real_robot_nerf_actor_tpu_torch.ops.resnetfc_cuda import (
        fused_gather_resnetfc_int8, fused_resnetfc_int8)
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
    from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer
    from real_robot_nerf_actor_tpu_torch.render.renderer import psnr
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    counters = {"flash_attention": (flash_attention, "wgmma_launches"),
                "conv3d_k3": (conv3d_k3, "wgmma_launches"),
                "conv3d_k3_vjp": (conv3d_k3, "vjp_calls"),
                "spatial_stats_3d": (spatial_stats_3d, "cuda_launches"),
                "corner_lerp": (corner_lerp, "cuda_launches"),
                "corner_lerp_vjp": (corner_lerp, "vjp_calls"),
                "ray_expand": (ray_expand, "cuda_launches"),
                "fused_resnetfc_int8": (fused_resnetfc_int8, "wgmma_launches"),
                "fused_gather_resnetfc_int8": (fused_gather_resnetfc_int8, "wgmma_launches")}

    def zero():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def sync():
        torch.cuda.synchronize()

    base = from_dict(NerfActConfig, NERFACT)
    cfg = dataclasses.replace(
        base, peract=dataclasses.replace(base.peract, model=dataclasses.replace(
            base.peract.model, conv_backend="pallas")),
        renderer=dataclasses.replace(base.renderer, fused_gather=True))
    field_eval = dataclasses.replace(cfg.renderer.field, mlp_backend="pallas_int8",
                                     int8_static_act=True, gather_fused_mlp=False)
    cfg_eval = dataclasses.replace(
        cfg, peract=dataclasses.replace(cfg.peract, model=dataclasses.replace(
            cfg.peract.model, use_flash_attention=True, stats_backend="pallas")),
        renderer=dataclasses.replace(cfg.renderer, field=field_eval))
    tmp = tempfile.TemporaryDirectory(prefix="replay_")
    det = contextlib.ExitStack()
    try:
        root = tmp.name + "/multi"
        t0 = time.perf_counter()
        manifest = write_multi_kitchen_dataset(root, device=dev, **REPLAY_DATA)
        write_s = time.perf_counter() - t0
        entries = load_multitask_entries(root)
        n_kf = sum(ReplaySource(e["root"], e["n_demos"]).num_keyframes(d)
                   for e in entries for d in range(e["n_demos"]))

        tr = NerfActTrainer(cfg, device=dev)
        state = tr.init_state(torch.Generator().manual_seed(0))
        state.module["nerf"].load_state_dict(random_field_state(torch, tr.renderer, seed=1))
        gen = torch.Generator(device=dev).manual_seed(1)
        sync()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        data = tr.multi_replay_data(entries, batch_size=1, seed=0)
        batch = next(data)
        sync()
        staging_s = time.perf_counter() - t0
        staged_delta = torch.cuda.memory_allocated() - mem0
        h, w = REPLAY_DATA["image_hw"]
        n_max = cfg.peract.voxelizer.max_num_coords
        # each keyframe's padded cloud (points, colors fp32, valid bool) and
        # its view (rgb, embed, depth fp32), staged once
        staged_bytes = n_kf * (n_max * (12 + 12 + 1)
                               + h * w * (3 + REPLAY_DATA["d_embed"] + 1) * 4)

        # the staged labels (computed on the card) against the CPU's
        label_diff = 0
        for e in entries:
            src = ReplaySource(e["root"], e["n_demos"])
            for d in range(e["n_demos"]):
                demo = src.demos[d]
                got, want = [], []
                for device, out in ((dev, got), (torch.device("cpu"), want)):
                    b = tr.bounds.to(device)
                    xyz = torch.as_tensor(demo.xyz, device=device)
                    dd = discretize_action(
                        xyz, torch.as_tensor(demo.rotation, device=device),
                        torch.as_tensor(demo.gripper_open, device=device),
                        torch.ones((len(xyz),), device=device), b,
                        cfg.peract.model.voxel_size, cfg.peract.rotation_resolution)
                    out.append(torch.cat([dd.rot_grip, point_to_voxel_index(
                        xyz, cfg.peract.model.voxel_size, b)], dim=-1).cpu())
                label_diff += int((got[0] != want[0]).any(dim=-1).sum())

        grid_sample.FUSED_LERP_BACKEND = "pallas"
        try:
            times, losses, batches = [], [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(REPLAY_WARMUP + REPLAY_STEPS):
                if i == REPLAY_WARMUP:
                    zero()
                if i:
                    batch = next(data)
                batches.append(batch)
                sync()
                t = time.perf_counter()
                m = tr.train_step(state, batch, gen)[1]
                sync()
                if i >= REPLAY_WARMUP:
                    times.append((time.perf_counter() - t) * 1e3)
                losses.append(m["loss_total"].item())
            step_launches = read()
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            # one more step under the profiler; taken again (at most three
            # times) when the profile holds no event of the conv kernel or
            # the lerp: one H100 run's profile of this step kept 42.5 of its
            # ~123 ms of device events, while the launch counters and every
            # other profile of that run were whole
            for profile_attempts in range(1, 4):
                batch = next(data)
                batches.append(batch)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    tr.train_step(state, batch, gen)
                    sync()
                    step_wall_ms = (time.perf_counter() - t) * 1e3
                rows = device_rows(torch, prof)
                step_device_ms = sum(x[1] for x in rows)
                step_kernels = kernel_counts(prof)
                if step_kernels["conv3d_k3"] and step_kernels["corner_lerp"]:
                    break
            del state, data

            # The eval's weights: the same steps once more, from the same
            # seed on the same batches, on deterministic algorithms, and the
            # eval on them too (until the phase ends), so that the eval and
            # its frame checks reproduce from run to run. With the default
            # algorithms the int8 frames' largest gap to the plain field
            # wandered between 0.02 and 0.04 from run to run on an H100
            # (the bound is 0.04): the atomics move d0 by rounding, and the
            # largest gap is the tail of int8 errors whose 99.9th
            # percentile is ~0.011.
            nondeterministic_ops = det.enter_context(deterministic_algorithms(torch))
            state = tr.init_state(torch.Generator().manual_seed(0))
            state.module["nerf"].load_state_dict(random_field_state(torch, tr.renderer, seed=1))
            gen = torch.Generator(device=dev).manual_seed(1)
            det_losses = [tr.train_step(state, b, gen)[1]["loss_total"].item() for b in batches]
        finally:
            grid_sample.FUSED_LERP_BACKEND = "xla"
        n_steps = REPLAY_STEPS
        eval_batch = batch   # the profiled step's: one kitchen-task's view

        # ---- the eval: the trained weights in a net with every knob on
        tr_eval = NerfActTrainer(cfg_eval, device=dev)
        state_eval = tr_eval.init_state(torch.Generator().manual_seed(0))
        state_eval.module.load_state_dict(state.module.state_dict())
        del state
        t0 = time.perf_counter()
        eval_fn = tr_eval.make_multi_replay_eval(entries)
        sync()
        eval_setup_s = time.perf_counter() - t0
        step = REPLAY_WARMUP + REPLAY_STEPS + 1
        calls = {}

        def spy_calls(rend, key):
            """Record each render_image call of `rend`: (d0, pose, focal, the
            generator's seed, the frame)."""
            inner = rend.render_image

            def render_image(d0, pose, focal, generator=None, **k):
                seed = generator.initial_seed()
                out = inner(d0, pose, focal, generator, **k)
                calls.setdefault(key, []).append((d0, pose, focal, seed, out[0]))
                return out
            rend.render_image = render_image

        rend_int8 = tr_eval.renderer
        spy_calls(rend_int8, "int8")
        zero()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            metrics = eval_fn(state_eval, step)
            sync()
            eval_s = time.perf_counter() - t
        eval_launches = read()
        eval_kernels = kernel_counts(prof)
        eval_rows = device_rows(torch, prof)

        # the plain field on the plain lookup (8 gathers with fp32 weights),
        # on the very d0 and draws of each recorded render
        rend_x = NeuralRenderer(dataclasses.replace(
            cfg_eval.renderer, fused_gather=False, field=dataclasses.replace(
                field_eval, mlp_backend="xla", int8_static_act=False)), device=dev)
        rend_x.field = state_eval.module["nerf"]

        def frame_check(call):
            d0, pose, focal, seed, rgb = call
            rgb_x = rend_x.render_image(d0, pose, focal,
                                        torch.Generator(device=dev).manual_seed(seed))[0]
            gap, db = (rgb - rgb_x).abs().max().item(), psnr(rgb, rgb_x).item()
            return {"max_rgb_gap": gap, "psnr_db": db, "xla_rgb_max": rgb_x.amax().item(),
                    "passes_check": gap <= RGB_TOL and db >= PSNR_MIN}

        checks = [frame_check(c) for c in calls["int8"]]
        # kernel 7: one render_eval with gather_fused_mlp true, held to the
        # same render_eval on kernel 6 bit for bit (as the render phase
        # holds the two), and against the plain field for the record
        spy_calls(rend_int8, "unfused")
        tr_eval.render_eval(state_eval, step, eval_batch)
        rend_gf = NeuralRenderer(dataclasses.replace(cfg_eval.renderer, field=dataclasses.replace(
            field_eval, gather_fused_mlp=True)), device=dev)
        spy_calls(rend_gf, "gather_fused")
        tr_eval.renderer = rend_gf
        fused_before = fused_gather_resnetfc_int8.wgmma_launches
        tr_eval.render_eval(state_eval, step, eval_batch)
        fused_launches = fused_gather_resnetfc_int8.wgmma_launches - fused_before
        gf_vs_unfused = (calls["gather_fused"][0][4]
                         - calls["unfused"][0][4]).abs().max().item()
        gf_check = frame_check(calls["gather_fused"][0])
        # planted fault: the pack of a field drawn from another seed
        wrong = NeuralRenderer(cfg_eval.renderer, device=dev)
        wrong.load_field(random_field_state(torch, wrong, seed=99))
        spy_calls(rend_int8, "wrong_pack")
        rend_int8._pack = lambda: setattr(rend_int8, "_packed", wrong._packed)
        tr_eval.renderer = rend_int8
        tr_eval.render_eval(state_eval, step, eval_batch)
        fault_check = frame_check(calls["wrong_pack"][0])
        del rend_int8._pack
        lit = max(c["xla_rgb_max"] for c in checks)
    finally:
        det.close()
        tmp.cleanup()

    want_steps = {"conv3d_k3": n_steps, "conv3d_k3_vjp": n_steps,
                  "corner_lerp": 2 * n_steps, "corner_lerp_vjp": 2 * n_steps}
    emit("replay", data=dict(REPLAY_DATA, kitchens_tasks=len(entries),
                             keyframes=n_kf, instructions=manifest["instructions"],
                             cut="2 kitchens x 2 tasks x 2 demos x 5 keyframes, from the "
                                 "reference's 2 x 3 x 5"),
         write_s=write_s, staging_s=staging_s, staged_bytes=staged_bytes,
         staged_alloc_delta_bytes=staged_delta, staged_label_rows_differing_from_cpu=label_diff,
         warmup=REPLAY_WARMUP, steps=n_steps, p50_ms=statistics.median(times), step_ms=times,
         step_device_ms=step_device_ms, step_wall_ms_profiled=step_wall_ms,
         step_profile_attempts=profile_attempts, step_device_events=sum(x[2] for x in rows),
         step_top=[{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:8]],
         step_busy_share=step_device_ms / step_wall_ms, peak_mem_gb=peak_gb,
         loss_first=losses[0], loss_last=losses[-1], losses=losses,
         eval_weights_losses_deterministic=det_losses,
         nondeterministic_ops=nondeterministic_ops,
         step_launches=step_launches, step_kernels_profiled=step_kernels,
         eval_setup_s=eval_setup_s, eval_s=eval_s, eval_metrics=metrics,
         eval_launches=eval_launches,
         eval_kernels_profiled=eval_kernels, gather_fused_launches=fused_launches,
         frame_checks=checks, gather_fused_vs_unfused_max_gap=gf_vs_unfused,
         gather_fused_vs_xla=gf_check, planted_wrong_pack=fault_check,
         xla_rgb_max=lit, rgb_tol=RGB_TOL, psnr_min_db=PSNR_MIN,
         eval_top=[{"name": n[:80], "ms": ms, "count": c} for n, ms, c in eval_rows[:12]],
         card=card)
    if not all(map(math.isfinite, losses + det_losses)):
        fail(f"replay: non-finite loss {losses}, {det_losses}")
    for k, n in want_steps.items():
        if step_launches[k] != n:
            fail(f"replay: {k} launched {step_launches[k]} times in {n_steps} steps, want {n}")
    for k in ("conv3d_k3", "corner_lerp"):
        if not step_kernels[k]:
            fail(f"replay: the profiled step shows no {k} kernel: {step_kernels}")
    for k in ("flash_attention", "conv3d_k3", "spatial_stats_3d", "corner_lerp",
              "ray_expand", "fused_resnetfc_int8"):
        if not eval_launches[k] or not eval_kernels[k]:
            fail(f"replay: {k} did not launch in the eval: counters {eval_launches}, "
                 f"profile {eval_kernels}")
    if not fused_launches:
        fail("replay: the gather-fused render did not launch fused_gather_resnetfc_int8")
    if not lit > 0.05:
        fail(f"replay: the eval's frames are empty (largest rgb {lit})")
    if not checks or not all(c["passes_check"] for c in checks):
        fail(f"replay: an int8 frame of the eval differs from the plain field's: {checks}")
    if gf_vs_unfused > 1e-6:
        fail(f"replay: the gather-fused frame differs from the unfused one by {gf_vs_unfused}")
    if fault_check["passes_check"]:
        fail(f"replay: the frame check does not see the planted wrong pack: {fault_check}")


def featurenerf_first_step_check(torch, dev, cfg, sc, sd0, src_ord, line="featurenerf_grad"):
    """Phase 9's rule for the first FeatureNeRF step (FeatureNerfConfig
    `cfg`) from the weights `sd0` on the scene `sc` (its teacher features
    dumped) with `src_ord` as source views: the card (deterministic
    algorithms: bilinear_sample_2d's backward is an accumulating index_put_)
    against the CPU, same weights and draws, losses within LOSS_TOL and
    every gradient within GRAD_TOL of its tensor's largest |g|; a second
    card step gives the repeat gap; two planted faults (the view combine
    taken as max, uv with x and y swapped) must each fail the check.
    Returns the line's fields; fails naming `line`."""
    import numpy as np

    from real_robot_nerf_actor_tpu_torch.models import pixelnerf
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import FeatureNerfTrainer

    nv, h, w = sc.images.shape[:3]
    host = {"images": sc.images, "poses": sc.poses, "focal": np.float32(sc.focal),
            "features": sc.features, "src_ord": np.asarray(src_ord)}
    g = torch.Generator().manual_seed(2)
    r, rc = cfg.ray_batch_size, cfg.renderer
    nf = rc.n_fine - rc.n_fine_depth
    draws = {"v": torch.randint(0, nv, (r,), generator=g),
             "y": torch.randint(0, h, (r,), generator=g),
             "x": torch.randint(0, w, (r,), generator=g)}
    render_draws = {"coarse_u": torch.rand(r, rc.n_coarse, generator=g),
                    "fine_u": torch.rand(r, nf, generator=g),
                    "fine_jitter": torch.rand(r, nf, generator=g),
                    "fine_depth_eps": torch.randn(r, rc.n_fine_depth, generator=g)}
    sample = pixelnerf.bilinear_sample_2d

    def first_step(device, fault=None):
        trd = FeatureNerfTrainer(cfg, device=device)
        s = trd.init_state(torch.Generator().manual_seed(0))
        s.module.load_state_dict(sd0)
        if fault == "combine_max":
            s.module.mlp.combine_type = "max"
        if fault == "uv_swapped":
            pixelnerf.bilinear_sample_2d = lambda feat, uv: sample(feat, uv.flip(-1))
        try:
            t = time.perf_counter()
            s, m = trd.train_step(s, {k_: torch.as_tensor(v, device=device)
                                      for k_, v in host.items()},
                                  draws=draws, render_draws=render_draws)
            if device != "cpu":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            pixelnerf.bilinear_sample_2d = sample
        return ({n: p.grad.detach().double().cpu() for n, p in s.module.named_parameters()},
                {k_: v.item() for k_, v in m.items()}, ms)

    g_cpu, m_cpu, cpu_ms = first_step("cpu")

    def gap(got):
        """(worst loss gap over LOSS_TOL, worst gradient gap over
        GRAD_TOL, its tensor): 1 is the bound (update_gaps)."""
        g = update_gaps(torch, {"losses": got[1], "grads": got[0]},
                        {"losses": m_cpu, "grads": g_cpu}, 0.0)
        return g["loss"]["of_tol"], g["grad"]["of_tol"], g["grad"]["name"]

    with deterministic_algorithms(torch) as nondeterministic_ops:
        card_run = first_step(dev)
        repeat = first_step(dev)
        faults = {f: gap(first_step(dev, f)) for f in ("combine_max", "uv_swapped")}
    loss_gap, grad_gap, worst_t = gap(card_run)
    repeat_gap = max((card_run[0][n] - repeat[0][n]).abs().max().item() for n in g_cpu)
    res = dict(src_ord=list(src_ord), loss_card=card_run[1]["loss"],
               loss_cpu=m_cpu["loss"], loss_gap_of_tol=loss_gap, grad_gap_of_tol=grad_gap,
               worst_tensor=worst_t, tensors=len(g_cpu), loss_tol=LOSS_TOL,
               grad_tol=GRAD_TOL, repeat_gap=repeat_gap, card_step_ms=card_run[2],
               cpu_step_ms=cpu_ms, nondeterministic_ops=nondeterministic_ops,
               planted={f: {"loss_gap_of_tol": lg, "grad_gap_of_tol": gg, "worst_tensor": n}
                        for f, (lg, gg, n) in faults.items()})
    if not (loss_gap <= 1.0 and grad_gap <= 1.0):
        emit(line, **res)
        fail(f"{line}: card vs CPU: loss {loss_gap}, gradient {grad_gap} "
             f"({worst_t}) of tolerance")
    for f, (lg, gg, _) in faults.items():
        if lg <= 1.0 and gg <= 1.0:
            emit(line, **res)
            fail(f"{line}: planted fault {f} passes the check")
    return res


def featurenerf_phase(torch, np, dev, card):
    """Phase 9: FeatureNeRF pretraining at full width.

    1. featurenerf_data: synthesize_scene_npz writes FNERF_SCENES into a
       temporary directory (focal 0.7 * 128); dump_teacher_features runs the
       ViT-S/8 teacher (384 wide, depth 12, 6 heads, image_size 128, grid
       16 x 16, fp32, weights from seed 0) over every view with --pca 0 and
       writes features (12, 16, 16, 384) and cls_attn (12, 6, 16, 16) into
       each file. Then pca_fit / pca_transform at PCA_COMPONENTS on the card
       over all dumped feature vectors, against a float64 numpy SVD: the
       projections within PCA_TOL of each component's scale, the explained
       variances within PCA_VAR_TOL of the top one, every component's sign
       (svd_flip) equal.
    2. featurenerf: configs/featurenerf.yaml with FEATURENERF_OVERRIDE
       (d_embed 384, field 512 x 5 blocks combining at 3, encoder (64, 64,
       128, 256), 512 rays of 64 + 32 samples, 16 of them around the coarse
       depth, lambda_coord 0.25, nviews [1], AdamW lr 1e-4); the train
       scenes staged once by scene_data; FNERF_WARMUP untimed steps and
       FNERF_STEPS timed ones; one step under the profiler (device time
       split into the encode, render, backward and optimizer ranges, top
       kernels, busy share); then one profiled step with FNERF_SRC3 as
       source views, so that the view combine runs on the card.
    3. featurenerf_grad: the first step from fresh weights on FNERF_SRC3,
       on the card (deterministic algorithms: bilinear_sample_2d's backward
       is an accumulating index_put_) and on the CPU, same weights and
       draws: losses within LOSS_TOL, every gradient within
       GRAD_TOL of its tensor's largest |g|; a second card step gives
       the repeat gap; two planted faults must each fail the check: the
       view combine taken as max, and uv with x and y swapped.
    4. featurenerf_eval: eval/novel.py's evaluate on the val scene (one
       full frame in tiles of 2048 rays) and one more frame of it, PSNR,
       SSIM and ms a frame; extract_radiance on one tile, shapes checked.
    Fails on a non-finite loss or metric, a wrong shape, a failed PCA or
    gradient check, and a planted fault that passes."""
    import glob
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import (
        SceneDataset, load_scene, synthesize_scene_npz)
    from real_robot_nerf_actor_tpu_torch.eval import novel
    from real_robot_nerf_actor_tpu_torch.eval.metrics import psnr_np, ssim_np
    from real_robot_nerf_actor_tpu_torch.ops.rays import gen_rays
    from real_robot_nerf_actor_tpu_torch.train.distill2d import dump_teacher_features
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import (
        FeatureNerfConfig, FeatureNerfTrainer)
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict
    from real_robot_nerf_actor_tpu_torch.utils.pca import pca_fit, pca_transform

    t_phase = time.perf_counter()
    cfg = from_dict(FeatureNerfConfig, {**FEATURENERF, **FEATURENERF_OVERRIDE})
    if cfg.model.d_embed != FNERF_TEACHER["embed_dim"]:
        fail("featurenerf: d_embed must be the teacher's width (--pca 0)")
    with tempfile.TemporaryDirectory() as root:
        # ------------------------------------------------------------- data
        t0 = time.perf_counter()
        for i in range(FNERF_SCENES["n_scenes"]):
            synthesize_scene_npz(os.path.join(root, f"scene_{i}.npz"),
                                 n_views=FNERF_SCENES["n_views"], hw=FNERF_SCENES["hw"], seed=i)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        info = dump_teacher_features(root, device=dev, **FNERF_TEACHER)
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t0
        paths = sorted(glob.glob(os.path.join(root, "*.npz")))
        scenes = [load_scene(p) for p in paths]
        nv, h, w = scenes[0].images.shape[:3]
        grid = (h // FNERF_TEACHER["patch"], w // FNERF_TEACHER["patch"])
        want_f = (nv, *grid, FNERF_TEACHER["embed_dim"])
        want_a = (nv, 6, *grid)
        for sc in scenes:
            if sc.features.shape != want_f or sc.cls_attn.shape != want_a:
                fail(f"featurenerf_data: features {sc.features.shape} attn {sc.cls_attn.shape}, "
                     f"want {want_f} / {want_a}")
            if not (np.isfinite(sc.features).all() and np.isfinite(sc.cls_attn).all()):
                fail("featurenerf_data: non-finite teacher output")
        feats = np.concatenate([sc.features for sc in scenes]).reshape(-1, want_f[-1])
        k = PCA_COMPONENTS
        x = torch.as_tensor(feats, device=dev)
        t0 = time.perf_counter()
        comps, mean, var = pca_fit(x, k)
        proj = pca_transform(x, comps, mean)
        torch.cuda.synchronize()
        pca_ms = (time.perf_counter() - t0) * 1e3
        xc = feats.astype(np.float64) - feats.astype(np.float64).mean(0)
        _, sv, vt = np.linalg.svd(xc, full_matrices=False)
        lam = sv ** 2 / (len(xc) - 1)
        idx = np.abs(vt[:k]).argmax(1)
        vt = vt[:k] * np.sign(vt[np.arange(k), idx])[:, None]
        p64 = xc @ vt.T
        proj_err = (np.abs(proj.double().cpu().numpy() - p64).max(0)
                    / np.abs(p64).max(0))
        var_errs = np.abs(var.double().cpu().numpy() - lam[:k]) / lam[0]
        var_err = float(var_errs.max())
        # where the variances' error comes from: the same fp32 covariance
        # decomposed in float64 on the card
        xd = x - x.mean(dim=0)
        cov = xd.T @ xd / (len(feats) - 1)
        ev64 = torch.linalg.eigvalsh(cov.double()).flip(-1)[:k].cpu().numpy()
        var_err_fp64_eigh = float((np.abs(ev64 - lam[:k]) / lam[0]).max())
        del xd, cov
        signs_equal = int(((comps.double().cpu().numpy() * vt).sum(1) > 0).sum())
        gaps = np.minimum(np.abs(np.diff(lam[:k + 1], prepend=np.inf))[:k],
                          np.abs(np.diff(lam[:k + 2]))[:k]) / lam[0]
        worst = int(proj_err.argmax())
        emit("featurenerf_data", scenes=len(scenes), views=nv, hw=[h, w],
             write_s=write_s, dump_s=dump_s, teacher=info["teacher"],
             teacher_cfg=FNERF_TEACHER, feature_shape=list(want_f), attn_shape=list(want_a),
             pca_components=k, pca_vectors=len(feats), pca_ms=pca_ms,
             pca_max_proj_err_of_scale=float(proj_err.max()), pca_worst_component=worst,
             pca_worst_rel_gap=float(gaps[worst]), pca_min_rel_gap=float(gaps.min()),
             pca_var_err_of_top=var_err, pca_var_worst_component=int(var_errs.argmax()),
             pca_var_err_of_top_fp64_eigh=var_err_fp64_eigh,
             pca_signs_equal=signs_equal, pca_tol=PCA_TOL,
             pca_var_tol=PCA_VAR_TOL, card=card)
        if not (proj_err.max() <= PCA_TOL and var_err <= PCA_VAR_TOL and signs_equal == k):
            fail(f"featurenerf_data: PCA against float64 SVD: projections {proj_err.max()} "
                 f"(component {worst}), variances {var_err}, {signs_equal}/{k} signs equal")
        del x, proj

        # ------------------------------------------------------------ train
        train_ds, val_ds = SceneDataset(root, "train"), SceneDataset(root, "val")
        staged_bytes = sum(4 + sum(a.nbytes for a in (sc.images, sc.poses, sc.features,
                                                      sc.cls_attn))
                           for p, sc in zip(paths, scenes) if p in train_ds.paths)
        tr = FeatureNerfTrainer(cfg, device=dev)
        state = tr.init_state(torch.Generator().manual_seed(0))
        sd0 = {n: v.detach().cpu().clone() for n, v in state.module.state_dict().items()}
        t0 = time.perf_counter()
        data = tr.scene_data(train_ds, seed=0)
        first = next(data)
        torch.cuda.synchronize()
        staging_s = time.perf_counter() - t0
        gen = torch.Generator().manual_seed(1)
        torch.cuda.reset_peak_memory_stats()
        times, losses, first_metrics = [], [], None
        for i in range(FNERF_WARMUP + FNERF_STEPS):
            batch = first if i == 0 else next(data)
            t = time.perf_counter()
            state, m = tr.train_step(state, batch, gen)
            torch.cuda.synchronize()
            if i >= FNERF_WARMUP:
                times.append((time.perf_counter() - t) * 1e3)
            losses.append(m["loss"].item())
            first_metrics = first_metrics or {k_: v.item() for k_, v in m.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

        def profiled(batch):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                _, m = tr.train_step(state, batch, gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            rows = device_rows(torch, prof)
            device_ms = sum(r[1] for r in rows)
            split = {k_: range_device_ms(torch, prof, f"featurenerf.{k_}")
                     for k_ in ("encode", "render", "optimizer")}
            # autograd runs the backward on its own thread, outside the range
            split["backward"] = device_ms - sum(split.values())
            return dict(src_views=int(batch["src_ord"].numel()), step_wall_ms=wall_ms,
                        device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                        device_events=sum(r[2] for r in rows), split_device_ms=split,
                        loss=m["loss"].item(),
                        top_kernels=[{"name": n[:80], "ms": ms, "count": c}
                                     for n, ms, c in rows[:12]])

        prof1 = profiled(next(data))
        prof3 = profiled(dict(next(data), src_ord=torch.tensor(FNERF_SRC3, device=dev)))
        emit("featurenerf", config=dict(FEATURENERF, **FEATURENERF_OVERRIDE),
             deviation="z_near 1.2, z_far 4.0 (the file's 0.5-1.8 m band misses the "
                       "synthetic arc at 2.2 m)",
             train_scenes=len(train_ds), staging_s=staging_s, staged_bytes=staged_bytes,
             warmup=FNERF_WARMUP, steps=FNERF_STEPS, p50_ms=statistics.median(times),
             step_ms=times, losses=losses, first_step_metrics=first_metrics,
             peak_mem_gb=peak_gb, profiled_step=prof1, profiled_step_3_views=prof3, card=card)
        if not all(map(math.isfinite, losses + [prof1["loss"], prof3["loss"]])):
            fail(f"featurenerf: non-finite loss {losses}")

        # ------------------------------------------------------- grad check
        res = featurenerf_first_step_check(torch, dev, cfg, train_ds[0], sd0, FNERF_SRC3)
        emit("featurenerf_grad", **res, card=card)

        # ------------------------------------------------------------- eval
        t0 = time.perf_counter()
        res = novel.evaluate(tr, state.module, val_ds, n_scenes=1, n_corr=0)
        sc = val_ds[0]
        with torch.no_grad():
            enc = tr.encode(state.module, torch.as_tensor(sc.images[:1], device=dev),
                            torch.as_tensor(sc.poses[:1], device=dev), float(sc.focal))
        view = 1
        t = time.perf_counter()
        rgb, emb = novel.render_view(tr, state.module, sc, enc, view,
                                     torch.Generator(device=dev).manual_seed(1))
        frame2_ms = (time.perf_counter() - t) * 1e3
        frames = [dict(view=len(sc.images) // 2, psnr=res["scenes"][0]["psnr"],
                       ssim=res["scenes"][0]["ssim"], ms=res["scenes"][0]["frame_ms"][0]),
                  dict(view=view, psnr=psnr_np(rgb, sc.images[view]),
                       ssim=ssim_np(rgb.mean(-1), sc.images[view].mean(-1)), ms=frame2_ms)]
        rays = gen_rays(torch.as_tensor(sc.poses[view:view + 1], device=dev), w, h,
                        torch.tensor(float(sc.focal), device=dev), cfg.z_near,
                        cfg.z_far).reshape(-1, 8)[:novel.TILE]
        with torch.no_grad():
            rad = tr.renderer(state.module).extract_radiance(
                enc, rays, torch.Generator(device=dev).manual_seed(2))
        rad_shapes = {k_: list(v.shape) for k_, v in rad.items()}
        eval_s = time.perf_counter() - t0
    emit("featurenerf_eval", val_scenes=len(val_ds), frames=frames, tile=novel.TILE,
         embed_shape=list(emb.shape), radiance_shapes=rad_shapes, eval_s=eval_s,
         phase_wall_s=time.perf_counter() - t_phase, card=card)
    t_n, k_c = novel.TILE, cfg.renderer.n_coarse
    want_rad = {"points": [t_n, k_c, 3], "rgb": [t_n, k_c, 3], "sigma": [t_n, k_c],
                "embed": [t_n, k_c, cfg.model.d_embed], "weights": [t_n, k_c], "z": [t_n, k_c]}
    if rad_shapes != want_rad or not all(torch.isfinite(v).all() for v in rad.values()):
        fail(f"featurenerf_eval: extract_radiance {rad_shapes}, want {want_rad}")
    if emb.shape != (h, w, cfg.model.d_embed) or not all(
            math.isfinite(f["psnr"]) and math.isfinite(f["ssim"]) for f in frames):
        fail(f"featurenerf_eval: frames {frames}, embed {emb.shape}")
    if not (np.isfinite(rgb).all() and 0.0 <= rgb.min() and rgb.max() <= 1.0):
        fail("featurenerf_eval: rgb outside [0, 1]")
    return state, np.concatenate([sc.images for sc in scenes])


def splat_depth(np, seed, poses, h, w, focal):
    """z-depth of the synthetic scene's points splatted as synthesize_scene_npz
    splats its images (the nearest point a pixel, inf where none lands): the
    principal point at ((w-1)/2, (h-1)/2), as match_pixels reprojects."""
    from real_robot_nerf_actor_tpu_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(seed=seed)
    out = np.full((len(poses), h, w), np.inf, np.float32)
    for v, pose in enumerate(poses):
        w2c = np.linalg.inv(pose)
        p = scene.points @ w2c[:3, :3].T + w2c[:3, 3]
        z = -p[:, 2]
        keep = z > 1e-3
        p, z = p[keep], z[keep]
        u = (focal * p[:, 0] / z + w / 2).astype(np.int32)
        r = (-focal * p[:, 1] / z + h / 2).astype(np.int32)
        ok = (u >= 0) & (u < w) & (r >= 0) & (r < h)
        np.minimum.at(out[v], (r[ok], u[ok]), z[ok].astype(np.float32))
    return out


def teacher_phase(torch, np, dev, card):
    """Phase 11: the FeatureNeRF contrastive teacher at full width, the
    render panels and the pixelNeRF family's last two models.

    1. teacher_data: synthesize_scene_npz writes TEACHER_SCENES, each with
       the z-depth of its splatted points (splat_depth).
    2. teacher_load: the committed JAX teacher (TEACHER_MSGPACK, 3000 steps)
       through load_teacher_state (read_flax_msgpack, no flax): feature_maps
       of one scene's 12 views on the card against the CPU within FWD_TOL of
       their scale; its teacher_quality on the last two scenes (the CLI's
       held-out ones).
    3. teacher_grad: the CLI's first step from seed 0 (numpy's draws, the
       weights from torch.Generator(0)) on the card and on the CPU: losses
       within LOSS_TOL, gradients within GRAD_TOL of each tensor's largest
       |g| plus ULP_K times the CPU's response to a one-ulp move of the
       weights (as phase 10), parameters after the Adam step (update_gaps);
       three planted faults must each fail it: norm_uv's x and y swapped,
       the temperature dropped, TF32 on.
    4. teacher: TEACHER_STEPS steps of `fit` on the first six scenes: p50,
       one profiled step (device time, busy share), peak memory, the mean
       loss of the first and of the last 100 steps; the last must be lower.
    5. teacher_dump: the CLI (train/teacher.py main) resumes the trained
       state with --steps 0 --dump: features (12, 64, 64, 64) and cls_attn
       (12, 64, 64) in every scene; then one FeatureNeRF step of
       configs/featurenerf.yaml at d_embed 64 (and the z band override) on
       them, finite.
    6. panels: eval/novel.py's main with --out on a checkpoint of that
       step: each novel_{si}.png read back with read_png equals the tiled
       panel arrays at uint8.
    7. models: ConvEncoder (batch CONV_ENCODER_BATCH, 128 x 128) and
       ImplicitNet (IMPLICIT) forward and backward on the card against the
       CPU: outputs within FWD_TOL, gradients (of the weights and the
       input) within GRAD_TOL plus ULP_K times the CPU's own fp32 error (its
       gap to the CPU's float64 gradient); and the same in float64 within
       F64_TOL of each tensor's scale (ConvEncoder's GroupNorm over its 2 x 2
       bottleneck makes its fp32 gradients rounding-bound: the CPU's fp32
       input gradient sits 2.2% of its scale off its float64 one, so the
       fp32 bound is wide and the float64 comparison is the tight one).
    Returns nothing; fails on any check."""
    import glob
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.data.png import read_png, read_png_text
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import (
        SceneDataset, load_scene, save_scene, synthesize_scene_npz)
    from real_robot_nerf_actor_tpu_torch.eval import novel
    from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
    from real_robot_nerf_actor_tpu_torch.models.encoder2d import ConvEncoder
    from real_robot_nerf_actor_tpu_torch.models.implicit import ImplicitNet
    from real_robot_nerf_actor_tpu_torch.train import teacher
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import (
        FeatureNerfConfig, FeatureNerfTrainer)
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager
    from real_robot_nerf_actor_tpu_torch.utils import visualize
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    t_phase = time.perf_counter()
    cpu_s = [0.0]      # seconds of the CPU references

    def on_cpu(fn):
        t = time.perf_counter()
        try:
            return fn()
        finally:
            cpu_s[0] += time.perf_counter() - t

    msgpack = str(Path(__file__).resolve().parent / TEACHER_MSGPACK)
    with tempfile.TemporaryDirectory() as root:
        # ------------------------------------------------------------ 1. data
        t0 = time.perf_counter()
        data = os.path.join(root, "scenes")
        os.makedirs(data)
        for i in range(TEACHER_SCENES["n_scenes"]):
            path = os.path.join(data, f"scene_{i}.npz")
            h, w = TEACHER_SCENES["hw"]
            sc = synthesize_scene_npz(path, n_views=TEACHER_SCENES["n_views"], hw=(h, w),
                                      seed=i)
            sc.depth = splat_depth(np, i, sc.poses, h, w, sc.focal)
            sc.features = None
            save_scene(path, sc)
        paths = sorted(glob.glob(os.path.join(data, "*.npz")))
        scenes = [load_scene(p) for p in paths]
        covered = float(np.mean([np.isfinite(sc.depth).mean() for sc in scenes]))
        emit("teacher_data", scenes=len(scenes), views=TEACHER_SCENES["n_views"],
             hw=list(TEACHER_SCENES["hw"]), write_s=time.perf_counter() - t0,
             depth_covered_share=covered, card=card)

        # ------------------------------------------------ 2. the JAX teacher
        cfg = teacher.TeacherConfig()
        tr = teacher.TeacherTrainer(cfg, device=dev)
        tr_cpu = teacher.TeacherTrainer(cfg, device="cpu")
        t0 = time.perf_counter()
        loaded = teacher.load_teacher_state(msgpack, tr.init_state())
        load_s = time.perf_counter() - t0
        loaded_cpu = on_cpu(lambda: teacher.load_teacher_state(msgpack, tr_cpu.init_state()))
        t0 = time.perf_counter()
        f_card, a_card = tr.feature_maps(loaded, scenes[0].images)
        maps_s = time.perf_counter() - t0
        f_cpu, a_cpu = on_cpu(lambda: tr_cpu.feature_maps(loaded_cpu, scenes[0].images))
        feat_err = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
        attn_err = float(np.abs(a_card - a_cpu).max())
        quality = teacher.teacher_quality(loaded, tr, scenes[-2:], np.random.default_rng(123))
        emit("teacher_load", path=TEACHER_MSGPACK, step=loaded.step, load_s=load_s,
             feature_shape=list(f_card.shape), feature_maps_s=maps_s,
             card_vs_cpu_feature_err_of_scale=feat_err, attn_err=attn_err, tol=FWD_TOL,
             quality_on_these_scenes=quality,
             quality_jax_recorded={"matched_cosine": 0.753, "random_cosine": 0.011,
                                   "teacher_corr_at2px": 0.535}, card=card)
        nv, (h, w) = TEACHER_SCENES["n_views"], TEACHER_SCENES["hw"]
        want_f, want_a = (nv, h // 2, w // 2, cfg.d_embed), (nv, h // 2, w // 2)
        if not (loaded.step == 3000 and f_card.shape == want_f and feat_err <= FWD_TOL):
            fail(f"teacher_load: step {loaded.step}, features {f_card.shape}, card vs CPU "
                 f"{feat_err} of scale (at most {FWD_TOL})")
        del loaded, loaded_cpu

        # --------------------------------------------- 3. the first step
        train_scenes, val_scenes = scenes[:-2], scenes[-2:]
        rng = np.random.default_rng(0)
        while True:
            si = int(rng.integers(0, len(train_scenes)))
            sc = train_scenes[si]
            i, j = rng.choice(len(sc.images), 2, replace=False)
            match = teacher.match_pixels(sc.poses, sc.focal, sc.depth, int(i), int(j),
                                         cfg.n_pairs, rng, cfg.depth_tol)
            if match is not None:
                break
        pair = np.stack([sc.images[int(i)], sc.images[int(j)]]).astype(np.float32)
        sd0 = tr_cpu.init_state(torch.Generator().manual_seed(0)).module.state_dict()
        sample = teacher.bilinear_sample_2d

        def first_step(device, fault=None):
            trd = teacher.TeacherTrainer(cfg if fault != "temperature_dropped" else
                                         dataclasses.replace(cfg, temperature=1.0),
                                         device=device)
            st = trd.init_state()
            st.module.load_state_dict(sd0)
            if fault in ("ulp_up", "ulp_down"):
                move_one_ulp(torch, list(st.module.parameters()), 1 if fault == "ulp_up" else -1)
            if fault == "uv_x_y_swapped":
                teacher.bilinear_sample_2d = lambda feat, uv: sample(feat, uv.flip(-1))
            try:
                st, m = trd.train_step(st, torch.as_tensor(pair, device=device),
                                       torch.as_tensor(match[0], device=device),
                                       torch.as_tensor(match[1], device=device))
            finally:
                teacher.bilinear_sample_2d = sample
            named = dict(st.module.named_parameters())
            return {"losses": {k: float(v) for k, v in m.items() if k != "pair_acc"},
                    "grads": {n: p.grad.detach().double().cpu() for n, p in named.items()},
                    "params": {n: p.detach().double().cpu() for n, p in named.items()}}

        ref = on_cpu(lambda: first_step("cpu"))
        # each gradient's bound widens by ULP_K times the largest change that
        # moving every weight one ulp (by seeded coins, then turned over)
        # makes in it on the CPU, as phase 10 widens its fine-tunes': the
        # train-mode BatchNorm's fast variance E[x^2] - E[x]^2 cancels where
        # a channel's mean dwarfs its spread, so the encoder's gradients move
        # by more than GRAD_TOL with the rounding of the sums (an H100's
        # first step read 27.6x GRAD_TOL unwidened, on
        # stage1_block1.Conv_0.weight)
        moved = on_cpu(lambda: [first_step("cpu", f)["grads"] for f in ("ulp_up", "ulp_down")])
        slack = {n: ULP_K * max((w - m[n]).abs().max() for m in moved)
                 for n, w in ref["grads"].items()}
        slack_ratio = {n: (slack[n] / (GRAD_TOL * w.abs().max() + 1e-30)).item()
                       for n, w in ref["grads"].items()}
        with deterministic_algorithms(torch) as nondeterministic_ops:
            card_run = first_step(dev)
            faults = {f: update_gaps(torch, first_step(dev, f), ref, cfg.lr, slack=slack)
                      for f in ("uv_x_y_swapped", "temperature_dropped")}
            with tf32(torch, True):
                faults["tf32"] = update_gaps(torch, first_step(dev), ref, cfg.lr, slack=slack)
        gaps = update_gaps(torch, card_run, ref, cfg.lr, slack=slack)
        emit("teacher_grad", pairs=int(match[0].shape[0]), scene=si, views=[int(i), int(j)],
             loss_card=card_run["losses"]["loss"], loss_cpu=ref["losses"]["loss"],
             gaps=gaps, grad_gap_unwidened=update_gaps(torch, card_run, ref, cfg.lr)["grad"],
             ulp_slack_of_grad_tol=dict(sorted(slack_ratio.items(),
                                               key=lambda kv: -kv[1])[:4]),
             tensors=len(ref["grads"]), loss_tol=LOSS_TOL, grad_tol=GRAD_TOL, ulp_k=ULP_K,
             nondeterministic_ops=nondeterministic_ops, planted=faults, card=card)
        if not passes(gaps):
            fail(f"teacher_grad: the card's first step against the CPU's: {gaps}")
        for f, g in faults.items():
            if passes(g):
                fail(f"teacher_grad: the planted fault {f} passes the check: {g}")

        # ------------------------------------------------------ 4. training
        state = tr.init_state(torch.Generator().manual_seed(0))
        losses, times = [], []
        last = [time.perf_counter()]

        def on_step(step, m):
            losses.append(m["loss"].item())       # the sync of the step
            now = time.perf_counter()
            times.append((now - last[0]) * 1e3)
            last[0] = now

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last[0] = t0
        state = teacher.fit(tr, state, train_scenes, TEACHER_STEPS, seed=0,
                            log_every=TEACHER_STEPS, callback=on_step)
        train_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        imgs = torch.as_tensor(pair, device=dev)
        uv = [torch.as_tensor(x, device=dev) for x in match]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tr.train_step(state, imgs, *uv)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = device_rows(torch, prof)
        device_ms = sum(r[1] for r in rows)
        first100, last100 = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
        quality = teacher.teacher_quality(state, tr, val_scenes, np.random.default_rng(123))
        emit("teacher", steps=TEACHER_STEPS, train_s=train_s,
             p50_ms=statistics.median(times[1:]), step_ms_p90=float(np.percentile(times, 90)),
             profiled_step_wall_ms=wall_ms, device_ms=device_ms,
             device_busy_share=device_ms / wall_ms, device_events=sum(r[2] for r in rows),
             top_kernels=[{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:10]],
             peak_mem_gb=peak_gb, loss_step0=losses[0], loss_mean_first100=first100,
             loss_mean_last100=last100, loss_every100=losses[::100] + [losses[-1]],
             quality_val=quality, jax_log={"step0": 4.71, "step1000": 2.18}, card=card)
        if not (all(map(math.isfinite, losses)) and last100 < first100):
            fail(f"teacher: the mean loss of the last 100 steps {last100} is not below the "
                 f"first 100's {first100}")

        # ---------------------------------------------- 5. the CLI's dump
        saved = os.path.join(root, "teacher.pt")
        teacher.save_teacher_state(saved, state)
        del state
        t0 = time.perf_counter()
        q_cli = teacher.main(["--data-root", data, "--steps", "0", "--resume", saved, "--dump",
                              "--quality-out", os.path.join(root, "quality.json"),
                              "--device", "cuda"])
        dump_s = time.perf_counter() - t0
        scenes = [load_scene(p) for p in paths]
        bad = [(sc.features.shape, sc.cls_attn.shape) for sc in scenes
               if sc.features.shape != want_f or sc.cls_attn.shape != want_a]
        if bad:
            fail(f"teacher_dump: {bad}")
        fcfg = dict(FEATURENERF, **FEATURENERF_OVERRIDE)
        fcfg["model"] = dict(fcfg["model"], d_embed=64)
        cfg_path = os.path.join(root, "featurenerf.json")
        with open(cfg_path, "w") as f:
            json.dump(fcfg, f)
        ftr = FeatureNerfTrainer(from_dict(FeatureNerfConfig, fcfg), device=dev)
        fstate = ftr.init_state(torch.Generator().manual_seed(0))
        fstate, fm = ftr.train_step(fstate, next(ftr.scene_data(SceneDataset(data, "train"),
                                                                seed=0)),
                                    torch.Generator().manual_seed(1))
        fnerf_loss = fm["loss"].item()
        ck = os.path.join(root, "fnerf_ckpt")
        CheckpointManager(ck).save(fstate.step, fstate)
        emit("teacher_dump", dump_s=dump_s, feature_shape=list(scenes[0].features.shape),
             attn_shape=list(scenes[0].cls_attn.shape), quality_after_dump=q_cli,
             featurenerf_step_loss=fnerf_loss,
             featurenerf_step_metrics={k: v.item() for k, v in fm.items()}, card=card)
        if not math.isfinite(fnerf_loss):
            fail(f"teacher_dump: the FeatureNeRF step's loss is {fnerf_loss}")
        del fstate, ftr

        # ------------------------------------------------------ 6. panels
        shown = []
        save_panel = visualize.save_render_panel

        def spy(path, gt, pred, **kw):
            shown.append((path, gt, pred, kw))
            return save_panel(path, gt, pred, **kw)

        panels = os.path.join(root, "panels")
        visualize.save_render_panel = spy
        try:
            res = novel.main(["--data-root", data, "--ckpt-dir", ck, "--config", cfg_path,
                              "--n-scenes", "1", "--n-corr", "0", "--out", panels,
                              "--device", "cuda"])
        finally:
            visualize.save_render_panel = save_panel
        files = sorted(os.listdir(panels))
        equal = []
        for path, gt, pred, kw in shown:
            want = visualize.tile([visualize.to_uint8(a) for _, a in
                                   visualize.render_panels(gt, pred)])
            got = read_png(path)
            equal.append(got.shape == want.shape and bool((got == want).all())
                         and read_png_text(path)["PSNR"] == f"{kw['psnr']:.2f}")
        emit("teacher_panels", files=files, shapes=[list(read_png(os.path.join(panels, f)).shape)
                                                    for f in files],
             read_back_equal=equal, novel_psnr=res["psnr_mean"], card=card)
        if files != ["novel_0.png"] or not (equal and all(equal)):
            fail(f"panels: {files}, read back equal: {equal}")

    # ------------------------------------------------------ 7. the models
    results = {}
    g = torch.Generator().manual_seed(3)
    enc = init_weights(ConvEncoder(), torch.Generator().manual_seed(0))
    x = torch.rand((CONV_ENCODER_BATCH, 128, 128, 3), generator=g)
    imp_kw = {k: v for k, v in IMPLICIT.items() if k != "points"}
    imp = init_weights(ImplicitNet(**imp_kw), torch.Generator().manual_seed(1))
    pts = torch.randn((IMPLICIT["points"], IMPLICIT["d_in"]), generator=g)
    for name, module, inp in (("conv_encoder", enc, x), ("implicit_net", imp, pts)):
        def run(device, dtype=torch.float32):
            m = copy.deepcopy(module).to(device, dtype)
            for sub in m.modules():      # ImplicitNet's layers compute in their dtype
                if getattr(sub, "dtype", None) is not None:
                    sub.dtype = dtype
            xi = inp.detach().to(device, dtype).clone().requires_grad_()
            out = m(xi)
            c = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(
                device, dtype)
            out.backward(c)
            if device != "cpu":
                torch.cuda.synchronize()
            return {"outputs": {"out": out.detach().double().cpu()},
                    "grads": {**{n: p.grad.double().cpu() for n, p in m.named_parameters()},
                              "input": xi.grad.double().cpu()},
                    "losses": {}}

        ref = on_cpu(lambda: run("cpu"))
        ref64 = on_cpu(lambda: run("cpu", dtype=torch.float64))
        # each fp32 gradient's bound widens by ULP_K times the CPU's own fp32
        # error, its gap to the CPU's float64 gradient (read on the CPU only):
        # ConvEncoder's GroupNorm takes its fast variance E[x^2] - E[x]^2 over
        # 16 values a group at the 2 x 2 bottleneck, which cancels, so its
        # fp32 gradients sit up to 2.2% of their scale off float64 on the CPU
        # (the input's), though two CPU thread counts agree to 1e-5; an H100
        # read the input gradient 38x GRAD_TOL from the CPU's unwidened
        slack = {n: ULP_K * (w - ref64["grads"][n]).abs().max() for n, w in ref["grads"].items()}
        with deterministic_algorithms(torch):
            run(dev)
            t = time.perf_counter()
            got = run(dev)
            ms = (time.perf_counter() - t) * 1e3
            # the same in float64, where rounding leaves the code path alone
            got64 = run(dev, dtype=torch.float64)
        gap64 = max(((got64[k][n] - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
                    for k in ("outputs", "grads") for n, w in ref64[k].items())
        gaps = update_gaps(torch, got, ref, 0.0, slack=slack)
        ratio = {n: (slack[n] / (GRAD_TOL * w.abs().max() + 1e-30)).item()
                 for n, w in ref["grads"].items()}
        results[name] = dict(shape=list(got["outputs"]["out"].shape), fwd_bwd_ms=ms,
                             gaps=gaps,
                             grad_gap_unwidened=update_gaps(torch, got, ref, 0.0)["grad"],
                             cpu_fp32_error_slack_of_grad_tol=dict(sorted(
                                 ratio.items(), key=lambda kv: -kv[1])[:3]),
                             card_fp32_vs_fp64_of_scale=max(
                                 ((got["grads"][n] - w).abs().max() / w.abs().max()).item()
                                 for n, w in got64["grads"].items()),
                             float64_max_gap_of_scale=gap64)
    emit("teacher_models", **results, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL,
         f64_tol=F64_TOL, phase_wall_s=time.perf_counter() - t_phase,
         phase_cpu_reference_s=cpu_s[0], card=card)
    for name, r in results.items():
        if not (passes(r["gaps"]) and r["float64_max_gap_of_scale"] <= F64_TOL):
            fail(f"teacher_models {name}: card vs CPU {r['gaps']}, float64 "
                 f"{r['float64_max_gap_of_scale']}")


def record_grads(torch, optimizers):
    """Wrap each (label, Optimizer)'s step to keep the gradients it steps
    on, as float64 CPU tensors under "label:name"; returns that dict."""
    log = {}
    for label, opt in optimizers:
        def recording(opt=opt, label=label, step=opt.step):
            for n, p in zip(opt.names, opt.params):
                if p.grad is not None:
                    log[f"{label}:{n}"] = p.grad.detach().double().cpu()
            return step()
        opt.step = recording
    return log


def named_cpu(modules):
    """{prefix.name: float64 CPU copy} of the parameters and buffers of
    (prefix, module) pairs."""
    return {f"{pre}.{n}": v.detach().double().cpu()
            for pre, m in modules for n, v in m.state_dict().items()}


def exact_bias_grads(torch, module):
    """Forward hooks on every Dense, Conv3d and ConvTranspose3d of `module`
    that has a bias: each keeps the float64 sum of its output's gradient
    over every axis but the last, which is the bias's gradient summed
    exactly. Returns the dict they fill ("<module>.bias") and the hooks'
    handles."""
    from real_robot_nerf_actor_tpu_torch.models.blocks import Conv3d, ConvTranspose3d, Dense
    store, handles = {}, []

    def keep(name, g):
        s = g.double().sum(dim=tuple(range(g.dim() - 1))).cpu()
        store[name] = store.get(name, 0) + s

    for name, m in module.named_modules():
        if isinstance(m, (Dense, Conv3d, ConvTranspose3d)) and m.bias is not None:
            def hook(mod, inp, out, name=f"{name}.bias"):
                if out.requires_grad:
                    out.register_hook(lambda g: keep(name, g))
            handles.append(m.register_forward_hook(hook))
    return store, handles


def move_one_ulp(torch, tensors, sign):
    """Move every entry of `tensors` one ulp: up or down by a seeded coin
    per entry, every coin turned over when sign < 0."""
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in tensors:
            up = (torch.rand(p.shape, generator=g) < 0.5) == (sign > 0)
            p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf).to(p)))


@contextlib.contextmanager
def tf32(torch, on):
    """TF32 in cuBLAS and cuDNN inside the block (when on): a planted fault,
    fp32 products at a 10-bit mantissa."""
    if on:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def update_gaps(torch, card, cpu, lr, slack=None):
    """The card's first update against the CPU's, as ratios to their bounds
    (1 is the bound), each with the worst name. Losses: LOSS_TOL relative.
    Gradients: e = GRAD_TOL of the tensor's largest |g|, plus slack[name]
    where given; a gradient that a side did not take counts as zeros there.
    Parameters after the step: 1e-6 relative plus 2e-5 lr, plus lr * min(2,
    2 e / |g|) for each gradient g that stepped the entry (Adam's step of an
    entry turns with the relative error of its gradient: a first step is lr
    * sign(g)). Outputs: FWD_TOL of their largest |value|."""
    slack = slack or {}
    by_name = {}
    for k, g in cpu["grads"].items():
        by_name.setdefault(k.split(":")[-1], []).append((g, slack.get(k, 0.0)))
    gaps = {"loss": {k: abs(card["losses"][k] - v) / (LOSS_TOL * max(abs(v), 1e-12))
                     for k, v in cpu["losses"].items()},
            "grad": {}, "param": {},
            "output": {n: ((card["outputs"][n] - w).abs().max()
                           / (FWD_TOL * w.abs().max() + 1e-30)).item()
                       for n, w in cpu.get("outputs", {}).items()}}
    for n in set(cpu["grads"]) | set(card["grads"]):
        if not n.endswith(INVARIANT):
            w, g = cpu["grads"].get(n), card["grads"].get(n)
            w = torch.zeros_like(g) if w is None else w
            g = torch.zeros_like(w) if g is None else g
            tol = GRAD_TOL * w.abs().max() + slack.get(n, 0.0) + 1e-30
            gaps["grad"][n] = ((g - w).abs() / tol).max().item()
    for n, w in cpu.get("params", {}).items():
        if n.endswith(INVARIANT):
            continue
        tol = 1e-6 * w.abs() + 2e-5 * lr
        for g, extra in by_name.get(n, []) + by_name.get(n.split(".", 1)[1], []):
            if g.shape == w.shape:
                e = GRAD_TOL * g.abs().max() + extra
                tol = tol + lr * torch.clamp(2 * e / g.abs().clamp_min(1e-30), max=2.0)
        gaps["param"][n] = ((card["params"][n] - w).abs() / tol).max().item()
    return {k: {"of_tol": d[max(d, key=d.get)], "name": max(d, key=d.get)}
            for k, d in gaps.items() if d}


def passes(gaps):
    return all(g["of_tol"] <= 1.0 for g in gaps.values())


def timed_profile(torch, fn, warmup, steps, profiles=None):
    """p50 host ms of `steps` calls after `warmup` (each synchronised), the
    peak memory over them, and one call under torch.profiler: device ms,
    busy share, device events, top kernels (the profile appended to
    `profiles` where given)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup + steps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    if profiles is not None:
        profiles.append(prof)
    rows = device_rows(torch, prof)
    device_ms = sum(r[1] for r in rows)
    return dict(p50_ms=statistics.median(times), ms=times, peak_mem_gb=peak,
                device_ms=device_ms, device_busy_share=device_ms / wall,
                device_events=sum(r[2] for r in rows),
                top_kernels=[{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:8]])


def bc_phase(torch, np, dev, card, fnerf_state, fnerf_views):
    """Phase 10: behaviour cloning and RL over the representation zoo, at
    full width with seed-drawn weights (no pretrained checkpoint is in the
    repository), fp32 with TF32 off.

    a. BCTrainer at BCConfig's defaults (batch 64, MLP head 256, Adam 3e-4)
       on 224 x 224 images: resnet50 fine-tuned (its BatchNorm running
       statistics trained) and frozen, dino (ViT-S/8, 785 tokens) and mvp
       (ViT-B/16) frozen;
    b. featurenerf: the encoder phase 9 trained (featurenerf_encoder_
       variables) fine-tuned on that phase's 128 x 128 views in [-1, 1];
    c. pointnet2 fine-tuned on 64 clouds of 4096 x 6 (_stack_obs's cap);
    d. DiffusionBC on resnet50 features (obs_dim 2048): an update and a
       100-step sample of the batch; one DiffusionQL.update_ql;
    e. SAC on 64 x 64 x 3 pixels, batch 128, from a seeded
       PrioritizedReplayBuffer: SAC_UPDATES updates (actor and target steps
       fire on every second one);
    f. two seeded point-cloud episodes through save_trajectory /
       EpisodeDataset into PerActTrainer of configs/peract.yaml with
       conv_backend "pallas": conv3d_k3 and its VJP must launch every step;
    g. extract_clip_features: the RN50 visual tower at 224 x 224, batch 8.
    Each part's first update (d: each of the three calls; g: the forward)
    on the card is held to the same on the CPU (update_gaps, with the
    same weights, inputs and draws). The fine-tunes (a, b, c) and f widen
    each gradient's bound by ULP_K times its response on the CPU to a
    one-ulp move of every weight (a, b, c: up and down, for max-pools over
    near-ties; f: the spatial softmax at T = 0.01); f's CPU reference takes each bias's
    gradient as the float64 sum of its output gradient. Planted
    faults must fail that check: the fine-tunes with the statistics left
    frozen and with TF32 on for the card's run, (e)'s actor gradient let
    into the encoder, and (f)'s conv3d_k3 VJP scaled by 1.01. Each line
    gives p50 and device ms per update, the busy share, the top kernels and
    peak memory; g's line the phase's wall time and its CPU references'
    share."""
    import tempfile

    from real_robot_nerf_actor_tpu_torch.data.demos import Trajectory
    from real_robot_nerf_actor_tpu_torch.data.episodes import EpisodeDataset, save_trajectory
    from real_robot_nerf_actor_tpu_torch.data.synthetic import make_synthetic_scene
    from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
    from real_robot_nerf_actor_tpu_torch.models.clip_visual import ClipVisualResNet
    from real_robot_nerf_actor_tpu_torch.models.representations import (
        featurenerf_encoder_variables)
    from real_robot_nerf_actor_tpu_torch.ops import conv3d_cuda
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.rl import PrioritizedReplayBuffer, SACAgent, SACConfig
    from real_robot_nerf_actor_tpu_torch.rl import diffusion_bc, sac
    from real_robot_nerf_actor_tpu_torch.train import bc
    from real_robot_nerf_actor_tpu_torch.train.distill2d import extract_clip_features
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    cpu = torch.device("cpu")
    cpu_total = [0.0]     # seconds of the CPU references, for the phase's card time

    B = BC_BATCH
    images = rng.uniform(0, 1, (B, BC_HW, BC_HW, 3)).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, 4)).astype(np.float32)

    def check(part, first, lr, faults=(), ulp=()):
        """first(device, fault) -> the update's record; fails unless the
        card holds to the CPU and every planted fault does not. ulp, of
        "ulp_up" and "ulp_down": each gradient's bound widens by ULP_K times
        the largest change that first(cpu, move) makes in it (every weight
        moved one ulp by seeded coins, or with the coins turned over: one of
        the two flips a max whose top two lie within rounding)."""
        t0 = time.perf_counter()
        want = first(cpu, None)
        out, slack = {}, None
        if ulp:
            moved = [first(cpu, f)["grads"] for f in ulp]
            slack = {n: ULP_K * max((w - m[n]).abs().max() for m in moved)
                     for n, w in want["grads"].items()}
            ratios = {n: (slack[n] / (GRAD_TOL * w.abs().max() + 1e-30)).item()
                      for n, w in want["grads"].items()}
            out["ulp_slack_of_grad_tol"] = dict(sorted(ratios.items(), key=lambda kv: -kv[1])[:4])
        cpu_s = time.perf_counter() - t0
        cpu_total[0] += cpu_s
        got = first(dev, None)
        gaps = update_gaps(torch, got, want, lr, slack=slack)
        if ulp:
            out["grad_gap_unwidened"] = update_gaps(torch, got, want, lr)["grad"]
        planted = {}
        for f in faults:
            with tf32(torch, f == "tf32"):
                planted[f] = update_gaps(torch, first(dev, f), want, lr, slack=slack)
        gc.collect()    # the trainers' recording wrappers hold them in cycles
        torch.cuda.empty_cache()
        if not passes(gaps):
            fail(f"bc {part}: the card's first update against the CPU's: {gaps}")
        for f, g in planted.items():
            if passes(g):
                fail(f"bc {part}: the check does not see the planted fault {f}: {g}")
        return dict(first_update_gaps=gaps, planted=planted, cpu_reference_s=cpu_s, **out)

    # -------------------------------------------------- a, b, c: BC updates
    def bc_part(part, name, obs, acts, freeze, encoder_sd=None, note=None):
        cfg = bc.BCConfig(embedding=name, freeze_encoder=freeze)

        def trainer(device, fault):
            restore = bc.train_statistics_
            if fault == "statistics_frozen":
                bc.train_statistics_ = lambda module: []
            try:
                tr = bc.BCTrainer(cfg, obs[0], seed=0, device=device)
            finally:
                bc.train_statistics_ = restore
            if encoder_sd is not None:
                tr.encoder.load_state_dict(encoder_sd)
            return tr

        init = trainer(cpu, None)
        init = {"policy": init.policy.state_dict(), "encoder": init.encoder.state_dict()}

        def first(device, fault):
            tr = trainer(device, fault)
            tr.policy.load_state_dict(init["policy"])
            tr.encoder.load_state_dict(init["encoder"])
            if fault in ("ulp_up", "ulp_down"):
                move_one_ulp(torch, [t for _, t in tr.trainable()], 1 if fault == "ulp_up" else -1)
            grads = record_grads(torch, [("adam", tr.optimizer)])
            loss = tr.update(obs, acts)
            return {"losses": {"loss": loss}, "grads": grads,
                    "params": named_cpu([("policy", tr.policy), ("encoder", tr.encoder)])}

        res = check(part, first, cfg.lr, () if freeze else ("statistics_frozen", "tf32"),
                    ulp=() if freeze else ("ulp_up", "ulp_down"))
        tr = trainer(dev, None)
        x = torch.as_tensor(obs, device=dev)
        a = torch.as_tensor(acts, device=dev)
        losses = []
        timing = timed_profile(torch, lambda: losses.append(tr.update(x, a)), BC_WARMUP,
                               BC_STEPS)
        emit("bc", part=part, embedding=name, freeze_encoder=freeze, obs_shape=list(obs.shape),
             batch=len(obs), head="mlp", hidden=cfg.hidden_dim, lr=cfg.lr,
             trained_statistics=0 if freeze else len(bc.train_statistics_(tr.encoder)),
             losses=losses, note=note, **timing, **res, card=card)
        if not all(map(math.isfinite, losses)):
            fail(f"bc {part}: non-finite loss {losses}")
        return tr

    tr50 = bc_part("a", "resnet50", images, actions, False)
    del tr50
    tr50 = bc_part("a", "resnet50", images, actions, True)
    with torch.no_grad():
        feats = tr50.embedding(torch.as_tensor(images, device=dev)).cpu().numpy()
    del tr50
    for name in ("dino", "mvp"):
        bc_part("a", name, images, actions, True)
    views = fnerf_views[:B] * 2.0 - 1.0
    bc_part("b", "featurenerf", views, actions[:len(views)], False,
            encoder_sd=featurenerf_encoder_variables(fnerf_state),
            note=f"{len(views)} of phase 9's views (its 8 scenes x 12)")
    clouds = rng.uniform(-0.5, 0.5, (B, 4096, 6)).astype(np.float32)
    bc_part("c", "pointnet2", clouds, actions, False,
            note="farthest-point sampling and ball query in plain torch")

    # ------------------------------------------------------ d: diffusion
    g = torch.Generator().manual_seed(3)
    dcfg = diffusion_bc.DiffusionBCConfig(obs_dim=feats.shape[1], action_dim=4)
    T = dcfg.n_timesteps
    draws = {"t": torch.randint(0, T, (B,), generator=g), "eps": torch.randn(B, 4, generator=g)}
    x0, noise = torch.randn(B, 4, generator=g), torch.randn(T, B, 4, generator=g)
    next_feats = np.roll(feats, 1, axis=0)
    reward = rng.standard_normal(B).astype(np.float32)
    not_done = (rng.uniform(size=B) > 0.1).astype(np.float32)
    ql_draws = dict(draws, next_x=x0, next_noise=noise, new_x=torch.randn(B, 4, generator=g),
                    new_noise=torch.randn(T, B, 4, generator=g), coin=True)

    def dbc_first(device, fault):
        ag = diffusion_bc.DiffusionBC(dcfg, seed=0, device=device)
        grads = record_grads(torch, [("adam", ag.optimizer)])
        loss = ag.update(feats, actions, **draws)
        sample = torch.as_tensor(ag.sample_action(feats, x=x0, noise=noise)).double()
        return {"losses": {"loss": loss}, "grads": grads, "params": named_cpu([("net", ag.net)]),
                "outputs": {"sample_100_steps": sample}}

    def ql_first(device, fault):
        qcfg = diffusion_bc.DiffusionQLConfig(obs_dim=feats.shape[1], action_dim=4)
        ag = diffusion_bc.DiffusionQL(qcfg, seed=0, device=device)
        grads = record_grads(torch, [("actor", ag.optimizer), ("critic", ag.critic_optimizer)])
        m = ag.update_ql(feats, actions, next_feats, reward, not_done, draws=ql_draws)
        return {"losses": m, "grads": grads,
                "params": named_cpu([("net", ag.net), ("ema", ag.ema), ("critic", ag.critic),
                                     ("critic_target", ag.critic_target)])}

    res_d = check("d", dbc_first, dcfg.lr)
    res_ql = check("d_ql", ql_first, dcfg.lr)
    ag = diffusion_bc.DiffusionBC(dcfg, seed=0, device=dev)
    fd, ad = torch.as_tensor(feats, device=dev), torch.as_tensor(actions, device=dev)
    upd = timed_profile(torch, lambda: ag.update(fd, ad), BC_WARMUP, BC_STEPS)
    smp = timed_profile(torch, lambda: ag.sample_action(fd), 1, 3)
    ql = diffusion_bc.DiffusionQL(diffusion_bc.DiffusionQLConfig(obs_dim=feats.shape[1]),
                                  seed=0, device=dev)
    nfd = torch.as_tensor(next_feats, device=dev)
    qlt = timed_profile(torch, lambda: ql.update_ql(fd, ad, nfd, reward, not_done), 1, 3)
    emit("bc", part="d", head="diffusion", obs_dim=feats.shape[1], batch=B, n_timesteps=T,
         features="resnet50 (frozen, part a's batch)", update=upd, sample_100_steps=smp,
         update_ql=qlt, **res_d, ql_first_update_gaps=res_ql["first_update_gaps"],
         ql_cpu_reference_s=res_ql["cpu_reference_s"], card=card)
    del ag, ql

    # ----------------------------------------------------------- e: SAC
    scfg = SACConfig(obs_type="image")
    buf = PrioritizedReplayBuffer(4 * SAC_BATCH, (SAC_HW, SAC_HW, 3), scfg.action_dim, seed=0)
    frames = rng.uniform(0, 1, (4 * SAC_BATCH + 1, SAC_HW, SAC_HW, 3)).astype(np.float32)
    for i in range(4 * SAC_BATCH):
        buf.add(frames[i], rng.uniform(-1, 1, scfg.action_dim), rng.standard_normal(),
                frames[i + 1], i % 50 == 49)
    batch0 = buf.sample(SAC_BATCH)
    eps0 = {k: torch.randn(SAC_BATCH, scfg.action_dim, generator=g) for k in ("critic", "actor")}

    def leaky_actor_loss(self, obs, eps):
        mu, log_std = self.net.actor(self.net.encode(obs))     # not detached
        a, logp = sac._squash(mu, log_std, eps)
        with sac._no_grad_into(self.net.critic, self.net.encoder):
            q1, q2 = self.net.q(obs, a)
        return (torch.exp(self.log_alpha.detach()) * logp - torch.minimum(q1, q2)).mean(), logp

    def sac_first(device, fault):
        restore = SACAgent.actor_loss
        if fault == "actor_gradient_in_encoder":
            SACAgent.actor_loss = leaky_actor_loss
        try:
            ag = SACAgent(scfg, frames[0], seed=0, device=device)
            grads = record_grads(torch, [("critic", ag.critic_opt), ("actor", ag.actor_opt),
                                         ("alpha", ag.alpha_opt)])
            m = ag.update(batch0, eps=eps0)
        finally:
            SACAgent.actor_loss = restore
        params = named_cpu([("net", ag.net), ("target", ag.target)])
        params["alpha.log_alpha"] = ag.log_alpha.detach().double().cpu()
        return {"losses": {k: m[k] for k in ("critic_loss", "actor_loss", "alpha")},
                "grads": grads, "params": params}

    res_e = check("e", sac_first, scfg.critic_lr, ("actor_gradient_in_encoder",))
    ag = SACAgent(scfg, frames[0], seed=0, device=dev)
    fired = {"actor": 0, "target": 0}

    def sac_update():
        target_step = ag._step % scfg.target_update_freq == 0
        b = buf.sample(SAC_BATCH)
        m = ag.update(b)
        buf.update_priorities(b["idx"], m["td_abs"])
        fired["actor"] += "actor_loss" in m
        fired["target"] += target_step

    timing = timed_profile(torch, sac_update, 2, SAC_UPDATES)
    emit("bc", part="e", agent="SAC", obs_shape=[SAC_HW, SAC_HW, 3], batch=SAC_BATCH,
         updates=3 + SAC_UPDATES, steps_fired=fired, **timing, **res_e,
         note="p50 per update includes the host's prioritized sampling and the batch upload",
         card=card)
    if not (fired["actor"] > 0 and fired["target"] > 0):
        fail(f"bc e: actor / target steps fired {fired}")
    del ag

    # ------------------------------------------------- f: episodes -> PerAct
    base = from_dict(PerActConfig, PERACT)
    bounds = base.coord_bounds
    scene = make_synthetic_scene(seed=5)
    with tempfile.TemporaryDirectory() as root:
        for e in range(2):
            er = np.random.default_rng(100 + e)
            steps = 10
            ee = np.asarray(scene.box_centers[e % len(scene.box_centers)]) + np.cumsum(
                er.normal(0, 0.01, (steps, 3)), axis=0)
            ee[6] = ee[5]                                              # a stop
            obs = [{"points": scene.points + er.normal(0, 1e-3, scene.points.shape).astype(
                        np.float32), "colors": (scene.colors + 1.0) / 2.0} for _ in range(steps)]
            save_trajectory(f"{root}/ep{e}.npz", Trajectory(
                obs, list(er.uniform(-1, 1, (steps, 4))), [0.0] * steps,
                list(np.where(np.arange(steps) < 3, 1.0, 0.0)), list(ee), True))
        ds = EpisodeDataset(root, bounds, voxel_size=base.model.voxel_size,
                            rotation_resolution=base.rotation_resolution,
                            max_num_coords=base.voxelizer.max_num_coords)
    batches = ds.batches(batch_size=1, seed=0, device=dev)
    draws_f = torch.tensor([[0.37, -0.61, 0.18]])

    def peract_cfg(dtype):
        return dataclasses.replace(base, model=dataclasses.replace(
            base.model, conv_backend="pallas", compute_dtype=dtype))

    host = ds.get(0)

    def scaled_vjp(*args, **kw):
        return tuple(None if t is None else t * 1.01 for t in vjp(*args, **kw))

    def peract_first(device, fault):
        tr = PerActTrainer(peract_cfg("float32"), device=device)
        state = tr.init_state(torch.Generator().manual_seed(0))
        if fault in ("ulp_up", "ulp_down"):
            move_one_ulp(torch, state.module.parameters(), 1 if fault == "ulp_up" else -1)
        grads = record_grads(torch, [("adamw", state.optimizer)])
        exact, handles = exact_bias_grads(torch, state.module)
        if fault == "vjp_scaled":
            conv3d_cuda.conv3d_k3_vjp = scaled_vjp
        try:
            state, m = tr.train_step(state, {k: torch.as_tensor(v[None], device=device)
                                             for k, v in host.items()}, draws=draws_f.to(device))
        finally:
            conv3d_cuda.conv3d_k3_vjp = vjp
            for h in handles:
                h.remove()
        if fault is None:
            sum_gap[device.type] = max((((grads[f"adamw:{n}"] - v).abs().max()
                                         / (v.abs().max() + 1e-30)).item(), n)
                                       for n, v in exact.items() if not n.endswith(INVARIANT))
        # the CPU's conv_transpose3d sums its bias gradient over the 10^6
        # voxels in fp32 ~1e-3 of the gradient's scale off the exact sum
        # (sum_gap): the reference takes every bias's gradient as the
        # float64 sum of its fp32 output gradient; the card keeps its own
        if device == cpu:
            grads.update({f"adamw:{n}": v for n, v in exact.items()})
        return {"losses": {"loss": m["loss"].item()}, "grads": grads,
                "params": named_cpu([("net", state.module)])}

    vjp = conv3d_cuda.conv3d_k3_vjp
    sum_gap = {}    # per side: its fp32 bias gradients off their float64 sums, of scale
    # one move: nothing in the step takes a max over near-ties
    res_f = check("f", peract_first, base.train.optim.lr, ("vjp_scaled",), ulp=("ulp_up",))
    tr = PerActTrainer(peract_cfg(base.model.compute_dtype), device=dev)
    state = tr.init_state(torch.Generator().manual_seed(0))
    counts = {"conv3d_k3": 0, "conv3d_k3_vjp": 0}
    losses = []

    def peract_step():
        b = next(batches)
        conv3d_k3.launches = conv3d_k3.vjp_calls = 0
        _, m = tr.train_step(state, b, draws=draws_f.to(dev))
        losses.append(m["loss"].item())
        counts["conv3d_k3"] += conv3d_k3.launches
        counts["conv3d_k3_vjp"] += conv3d_k3.vjp_calls

    profiles = []
    timing = timed_profile(torch, peract_step, 1, 4, profiles)
    by_name = kernel_counts(profiles[0])
    n = 6
    emit("bc", part="f", episodes=2, keyframe_pairs=len(ds), compute_dtype=base.model.compute_dtype,
         conv_backend="pallas", voxel_size=base.model.voxel_size,
         max_num_coords=base.voxelizer.max_num_coords, launches=counts, steps=n, losses=losses,
         profiled_step_kernels={k: v for k, v in by_name.items() if v},
         check_dtype="float32", fp32_bias_sum_gap=sum_gap,
         timed_step_held_by="phase 6 (train): the bf16 kernel step "
         "against the plain conv's, from the same weights", **timing, **res_f, card=card)
    if counts != {"conv3d_k3": n, "conv3d_k3_vjp": n} or by_name["conv3d_k3"] != 1:
        fail(f"bc f: launches {counts} over {n} steps, want {n} of each; the profiled "
             f"step's kernels {by_name}")
    if not all(map(math.isfinite, losses)):
        fail(f"bc f: non-finite loss {losses}")
    del tr, state

    # ------------------------------------------------------------- g: CLIP
    clip_cpu = init_weights(ClipVisualResNet(), torch.Generator().manual_seed(0)).eval()
    clip = copy.deepcopy(clip_cpu).to(dev)
    imgs = images[:CLIP_BATCH]
    got = extract_clip_features(clip, imgs)
    t0 = time.perf_counter()
    want = extract_clip_features(clip_cpu, imgs)
    cpu_total[0] += time.perf_counter() - t0
    err = float(np.abs(got - want).max() / np.abs(want).max())
    timing = timed_profile(torch, lambda: extract_clip_features(clip, imgs), 1, 5)
    emit("bc", part="g", tower="CLIP RN50 visual", batch=CLIP_BATCH, feature_shape=list(got.shape),
         max_err_of_scale=err, tol=FWD_TOL, **timing, phase_wall_s=time.perf_counter() - t_phase,
         phase_cpu_reference_s=cpu_total[0], card=card)
    if got.shape != (CLIP_BATCH, BC_HW // 32, BC_HW // 32, 2048) or not err <= FWD_TOL:
        fail(f"bc g: extract_clip_features {got.shape}, card vs CPU {err} of scale")


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


def camera_phase(torch, np, dev, card, server_on, server_off):
    """Phase 12: the reference's real-camera act path, the last models and
    ops, the profiling tool and the kernel cache.

    a. camera: CAMERA["frames"] raw depth frames at 480 x 640 of the
       synthetic scene (CAMERA["n_points"] points splatted by camera_frames
       through a RealSense D435's intrinsics, seeded noise and holes) go
       through DepthFilterPipeline on the host (the temporal state carried;
       a second pipeline must give the same bits), then on the card
       depth_to_pointcloud, transform_points by the camera-to-world
       extrinsic and the crop to serve.yaml's bounds, within POINT_TOL of
       the same on the CPU (the extrinsic applied transposed, a planted
       fault, must fail that); compat.VoxelGrid's grid on the card against
       the CPU's (occupancy equal, at most VOXEL_DIFF voxels with a channel
       more than 1e-5 apart); then CameraActor.step with
       phase 3's policy (kernels on) over the frames: the host ms a frame of
       the filters, the act p50, launches a step (flash attention 8, conv
       1, stats 3, through their own kernels), one profiled step (device
       ms, busy share, the kernels counted in the profile), and
       euler_to_quaternion of each decoded rotation. Under deterministic
       algorithms, compat.VoxelGrid -> the policy ->
       compat.choose_highest_action must decode the same action as
       CameraActor.step on the same points, and the plain path's logits
       (phase 3's server_off) stay within ACT_TOL of the kernel path's.
    b. camera_models: CNNLangAndFcsNet, CNNAndFcsNet (and SpatialSoftmax2D
       on its last conv map) and SiameseNet (two streams) at
       CAMERA_MODELS' widths; Visual3DLangTransformer (depth 1, 6 x 64) over
       8000 x 128 visual against 77 x 512 language tokens in fp32, bf16
       and float64; LanguageInformedVisualAttention on the policy's d0 of
       the first frame; MultiLayer3DEncoder on that frame's CPU-built grid in train
       and in eval mode: the first forward and backward on the card against
       the CPU's: in fp32 (fp32_check, tensor by tensor) every output (the
       running statistics in train mode too) within FWD_TOL of its scale,
       every gradient (of the weights and inputs) of fewer than SMALL_LEAF
       entries within GRAD_TOL of its scale and at most GRAD_SHARE of a
       larger one's entries beyond it, an output's bound widened by ULP_K
       times the CPU's own fp32-vs-float64 gap (phase 11's rule), a
       gradient's by the larger of that and ULP_K times its response on
       the CPU to a one-ulp move of every weight and input (phase 10's
       rule; gaps_unwidened without either); in float64
       every output and gradient within F64_TOL of its scale; the VL
       transformer's bf16 within BF16_FWD / BF16_GRAD of the scale plus the
       CPU's own bf16-vs-fp32 gap. The augmentations on phase 10 e's SAC
       pixel batch with the CPU's draws must equal the CPU's. Planted
       faults: TF32 on must fail the fp32 check of every model whose
       result it changes (it leaves the language gate's 1 x 512 product
       bit-equal, "no-op"); torch's
       symmetric padding in the CNN trunk (fp32 check) and exact GELU in
       the VL block (float64 check) must fail by more than 10 times their
       bounds.
    c. camera_ops: grid_sample_3d_fastbwd on FASTBWD's grid and samples in
       fp32 and bf16: the forward equal to grid_sample_3d, the grid
       gradient within FASTBWD_TOL of autograd's through grid_sample_3d,
       both backwards' device ms; composite_unsorted on COMPOSITE's rays
       against composite on the sorted samples (COMPOSITE_TOL).
    d. camera_tools: tools/profile_policy.py once (its top op classes);
       enable_persistent_cache into a temporary directory, after which the
       next load of csrc/corner_lerp.cu builds there and its launch equals
       the plain version.
    Returns nothing; fails on any check."""
    import os
    import tempfile
    import types

    import torch.nn.functional as F

    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch import compat
    from real_robot_nerf_actor_tpu_torch.data import augment
    from real_robot_nerf_actor_tpu_torch.data.depth_filters import (
        DepthFilterPipeline, depth_to_pointcloud)
    from real_robot_nerf_actor_tpu_torch.data.synthetic import (
        REALSENSE_INTRINSICS, camera_extrinsic, camera_frames, make_synthetic_scene)
    from real_robot_nerf_actor_tpu_torch.models import MultiLayer3DEncoder, encoder2d
    from real_robot_nerf_actor_tpu_torch.models import vl_attention
    from real_robot_nerf_actor_tpu_torch.models.blocks import BatchNorm, init_weights
    from real_robot_nerf_actor_tpu_torch.models.cnn_policies import (
        CNNAndFcsNet, CNNLangAndFcsNet, SiameseNet, SpatialSoftmax2D)
    from real_robot_nerf_actor_tpu_torch.models.vl_attention import (
        LanguageInformedVisualAttention, Visual3DLangTransformer)
    from real_robot_nerf_actor_tpu_torch.ops import _build, discretize_action
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.compositing import composite, composite_unsorted
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.geometry import (
        euler_to_quaternion, transform_points, voxel_index_to_point)
    from real_robot_nerf_actor_tpu_torch.ops.grid_sample import (
        grid_sample_3d, grid_sample_3d_fastbwd)
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp, corner_lerp_plain
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
    from real_robot_nerf_actor_tpu_torch.tools import profile_policy
    from real_robot_nerf_actor_tpu_torch.train.serve import CameraActor, camera_points
    from real_robot_nerf_actor_tpu_torch.utils.cache import enable_persistent_cache

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_s = [0.0]      # seconds of the CPU references

    def on_cpu(fn):
        t = time.perf_counter()
        try:
            return fn()
        finally:
            cpu_s[0] += time.perf_counter() - t

    # ------------------------------------------------------------ a. camera
    t0 = time.perf_counter()
    scene = make_synthetic_scene(seed=0, n_points=CAMERA["n_points"])
    K, ext = REALSENSE_INTRINSICS, camera_extrinsic()
    raw, rgb = camera_frames(scene, K, ext, CAMERA["hw"], CAMERA["frames"], seed=0)
    frames_s = time.perf_counter() - t0
    pipe, filtered, filter_ms = DepthFilterPipeline(), [], []
    for f in raw:
        t = time.perf_counter()
        filtered.append(pipe(f))
        filter_ms.append((time.perf_counter() - t) * 1e3)
    again = DepthFilterPipeline()
    if not all(np.array_equal(again(f), w) for f, w in zip(raw, filtered)):
        fail("camera: a second run of the host filters gave other bits")

    bounds, ext_t = server_on.bounds, torch.as_tensor(ext, device=dev)

    def world(depth, mat):
        cam = depth_to_pointcloud(depth, K, device=mat.device).reshape(-1, 3)
        return transform_points(cam, mat)

    point_gaps, fault_gaps, counts, crop_cpu = [], [], [], []
    transposed = ext.copy()
    transposed[:3, :3] = ext[:3, :3].T
    for d in filtered:
        want = on_cpu(lambda: world(d, ext_t.cpu()))
        scale = want.abs().max().item()
        point_gaps.append((world(d, ext_t).cpu() - want).abs().max().item() / scale)
        fault_gaps.append((world(d, torch.as_tensor(transposed, device=dev)).cpu()
                           - want).abs().max().item() / scale)
        counts.append(int(camera_points(d, rgb, K, ext_t, bounds)[0].shape[0]))
        crop_cpu.append(int(on_cpu(lambda: camera_points(d, rgb, K, ext_t.cpu(),
                                                         bounds.cpu()))[0].shape[0]))
    if not max(point_gaps) <= POINT_TOL:
        fail(f"camera: world points on the card vs the CPU {max(point_gaps)} > {POINT_TOL}")
    if not min(fault_gaps) > 10 * POINT_TOL:
        fail(f"camera: the point check does not see the extrinsic transposed ({fault_gaps})")

    m, v = server_on.voxelizer.max_num_coords, server_on.model_cfg.voxel_size
    grid_dev = compat.VoxelGrid(SERVE_FIELD["coord_bounds"], v, device=dev, max_num_coords=m)
    grid_cpu = compat.VoxelGrid(SERVE_FIELD["coord_bounds"], v, device="cpu", max_num_coords=m)
    pts0, cols0 = camera_points(filtered[0], rgb, K, ext_t, bounds)
    vox0 = grid_dev.coords_to_bounding_voxel_grid(pts0[None], cols0[None])
    vox0_cpu = on_cpu(lambda: grid_cpu.coords_to_bounding_voxel_grid(pts0.cpu()[None],
                                                                      cols0.cpu()[None]))
    vgap = (vox0.cpu() - vox0_cpu).abs()
    voxel_diff = dict(occupancy=int((vgap[..., -1] > 0).sum()),
                      any_channel_over_1e_5=int((vgap.amax(-1) > 1e-5).sum()),
                      max_gap=vgap.max().item(),
                      occupied=int((vox0_cpu[..., -1] > 0).sum()))
    if voxel_diff["occupancy"] or voxel_diff["any_channel_over_1e_5"] > VOXEL_DIFF:
        fail(f"camera: compat.VoxelGrid on the card vs the CPU {voxel_diff}")

    actor_on, actor_off = CameraActor(server_on, K, ext), CameraActor(server_off, K, ext)
    prop = (np.array([0.35, 0.2, 0.1], np.float32), np.array([0.0, 0.0, 90.0], np.float32), 1.0)
    for i in range(CAMERA_WARMUP):
        actor_on.step(filtered[i % len(filtered)], rgb, *prop).cpu()
    counters = (flash_attention, conv3d_k3, spatial_stats_3d)
    for c in counters:
        c.launches = 0
    flash_attention.wgmma_launches = conv3d_k3.wgmma_launches = 0
    spatial_stats_3d.cuda_launches = 0
    act_ms, packed_on = [], []
    for d in filtered:
        t = time.perf_counter()
        packed_on.append(actor_on.step(d, rgb, *prop).cpu())
        act_ms.append((time.perf_counter() - t) * 1e3)
    n = len(filtered)
    per_step = {c.__name__: c.launches / n for c in counters}
    per_step.update(flash_attention_wgmma=flash_attention.wgmma_launches / n,
                    conv3d_k3_wgmma=conv3d_k3.wgmma_launches / n,
                    spatial_stats_3d_cuda=spatial_stats_3d.cuda_launches / n)
    want_counts = {"flash_attention": 8, "conv3d_k3": 1, "spatial_stats_3d": 3,
                   "flash_attention_wgmma": 8, "conv3d_k3_wgmma": 1,
                   "spatial_stats_3d_cuda": 3}
    if per_step != want_counts:
        fail(f"camera: launches per act step {per_step}, want {want_counts}")
    plain_ms = []
    for d in filtered:
        t = time.perf_counter()
        actor_off.step(d, rgb, *prop).cpu()
        plain_ms.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        actor_on.step(filtered[-1], rgb, *prop).cpu()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = device_rows(torch, prof)
    device_ms = sum(r[1] for r in rows)
    profiled = {k: v for k, v in kernel_counts(prof).items()
                if k in ("flash_attention", "conv3d_k3", "spatial_stats_3d")}
    if profiled != {"flash_attention": 8, "conv3d_k3": 1, "spatial_stats_3d": 3}:
        fail(f"camera: the profiled step counted {profiled}")
    rot = torch.stack([p[0, 3:6] for p in packed_on]).to(dev)
    quats = euler_to_quaternion(torch.deg2rad(rot))
    if not ((quats.norm(dim=-1) - 1).abs().max().item() <= 1e-6):
        fail(f"camera: quaternions off the unit sphere {quats}")

    # the compat path and the plain path on the same points, deterministic
    decode_equal, logit_gaps = [], {}
    rr = server_on.cfg.rotation_resolution
    with deterministic_algorithms(torch) as nondeterministic, torch.inference_mode():
        for d in filtered:
            want = actor_on.step(d, rgb, *prop)
            pts, cols = camera_points(d, rgb, K, ext_t, bounds)
            vox = grid_dev.coords_to_bounding_voxel_grid(pts[None], cols[None])
            prev = discretize_action(torch.as_tensor(prop[0], device=dev)[None],
                                     torch.as_tensor(prop[1], device=dev)[None],
                                     torch.tensor([prop[2]], device=dev),
                                     torch.ones(1, device=dev), bounds, v, rr)
            proprio = torch.cat([prev.trans.float(), prev.rot_grip.float()], dim=-1)
            out_on = server_on.net(vox, proprio, server_on.lang)
            coords, rot_grip, coll = compat.choose_highest_action(
                out_on[0][:, None], out_on[1], out_on[2], rr)
            got = torch.cat([voxel_index_to_point(coords, v, bounds),
                             (rot_grip[:, :3].float() + 1.0) * rr - 180.0,
                             rot_grip[:, 3:4].float(), coll[:, :1].float()], dim=-1)
            decode_equal.append(bool(torch.equal(got, want)))
            out_off = server_off.net(vox, proprio, server_off.lang)
            for name, a, b in zip(("q_trans", "q_rot_grip", "q_collision"), out_on, out_off):
                a, b = a.float(), b.float()
                scale = max(1.0, b.abs().max().item())
                gap = (a - b).abs().max().item() / scale
                logit_gaps[name] = max(logit_gaps.get(name, 0.0), gap)
    d0 = out_on[3].float()
    emit("camera", frames=n, hw=list(CAMERA["hw"]), scene_points=CAMERA["n_points"],
         frames_s=frames_s, filter_host_ms=filter_ms, filter_host_ms_p50=statistics.median(filter_ms),
         raw_valid_share=float((raw > 0).mean()), filtered_valid=[int((d > 0).sum()) for d in filtered],
         cropped_points=counts, cropped_points_cpu=crop_cpu, max_num_coords=m,
         voxel_grid="truncated" if min(counts) >= m else ("padded" if max(counts) < m else "both"),
         point_gap_of_scale=max(point_gaps), point_tol=POINT_TOL,
         extrinsic_transposed=min(fault_gaps), voxels_card_vs_cpu=voxel_diff,
         act_p50_ms=statistics.median(act_ms), act_ms=act_ms,
         plain_p50_ms=statistics.median(plain_ms), launches_per_step=per_step,
         profiled_launches=profiled, step_wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, device_events=sum(r[2] for r in rows),
         top=[{"name": k[:80], "ms": v, "count": c} for k, v, c in rows[:8]],
         actions=[np.round(p[0].numpy().astype(float), 4).tolist() for p in packed_on],
         quaternions=np.round(quats.cpu().numpy().astype(float), 5).tolist(), card=card)
    emit("camera_compare", compat_decode_equal=decode_equal, logit_gap_of_scale=logit_gaps,
         tol_of_scale=ACT_TOL, ops_without_deterministic_version=nondeterministic, card=card)
    if not all(decode_equal):
        fail(f"camera: compat.VoxelGrid -> policy -> decode differs from CameraActor.step "
             f"({decode_equal})")
    if not max(logit_gaps.values()) <= ACT_TOL:
        fail(f"camera: kernel path vs plain path logits {logit_gaps}")

    # ------------------------------------------------------ b. camera_models
    cm = CAMERA_MODELS
    b, (h, w) = cm["batch"], cm["hw"]
    gen = torch.Generator().manual_seed(11)
    images = torch.rand((b, h, w, 3), generator=gen)
    low = torch.randn((b, cm["low_dim"]), generator=gen)
    lang_vec = torch.randn((b, cm["lang_dim"]), generator=gen)
    visual = torch.randn((1, *cm["vl_tokens"]), generator=gen)
    lang_tok = torch.randn((1, cm["lang_tokens"], cm["lang_dim"]), generator=gen)
    pooled = torch.randn((1, cm["lang_dim"]), generator=gen)
    d0_cpu = d0.cpu().clone()      # out of inference mode
    # the UNet's input: the CPU's grid of the first frame, the same in every
    # run (the card's grid moves in the last bits of its means from run to
    # run with index_add_'s atomics, and the deep layers' train-mode
    # gradients with them: one such run read 1.40 of the bound)
    vox_cpu = vox0_cpu.float()

    def seeded(module, seed):
        def make():
            mod = init_weights(module(), torch.Generator().manual_seed(seed))
            g = torch.Generator().manual_seed(seed + 1)
            with torch.no_grad():
                for sub in mod.modules():
                    if isinstance(sub, BatchNorm):   # statistics and affine off their init
                        sub.running_mean.copy_(torch.randn(sub.running_mean.shape, generator=g) * 0.1)
                        sub.running_var.uniform_(0.5, 1.5, generator=g)
                        sub.weight.uniform_(0.5, 1.5, generator=g)
                        sub.bias.copy_(torch.randn(sub.bias.shape, generator=g) * 0.1)
                    if isinstance(sub, vl_attention.VLCrossAttention):
                        sub.gate.fill_(0.7)           # flax's zero gate would hide the attention
            return mod
        return make

    def first_pass(make, inputs, call, device, dtype=torch.float32, buffers=False,
                   cots=None, time_it=False):
        """The first forward and backward of make() on `device` against the
        cotangents `cots` (drawn from a seed by the first call, which fills
        the dict): outputs (and the buffers, when asked), gradients of every
        weight and input, as float64 CPU tensors; with time_it, "ms" of a
        second forward and backward, synchronised, without the copies."""
        mod = make().to(device=device, dtype=dtype)
        if dtype == torch.float64:
            for sub in mod.modules():
                if getattr(sub, "dtype", None) is not None:
                    sub.dtype = dtype
        xs = [x.detach().to(device=device, dtype=dtype).clone().requires_grad_() for x in inputs]
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        outs = call(mod, xs)
        if not cots:
            g = torch.Generator().manual_seed(4)
            cots.update({k: torch.randn(o.shape, generator=g) for k, o in outs.items()})
        c_dev = {k: c.to(device, acc) for k, c in cots.items()}

        def backward(res):
            sum((o.to(acc) * c_dev[k]).sum() for k, o in res.items()).backward()

        backward(outs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        rec = {"outputs": {k: o.detach().double().cpu() for k, o in outs.items()},
               "grads": {**{k: p.grad.double().cpu() for k, p in mod.named_parameters()
                            if p.grad is not None},
                         **{f"input{i}": x.grad.double().cpu() for i, x in enumerate(xs)}},
               "losses": {}}
        if buffers:
            rec["outputs"].update({k: t.double().cpu() for k, t in mod.named_buffers()})
        if time_it:
            del outs
            mod.zero_grad(set_to_none=True)
            for x in xs:
                x.grad = None
            t = time.perf_counter()
            backward(call(mod, xs))
            torch.cuda.synchronize()
            rec["ms"] = (time.perf_counter() - t) * 1e3
        return rec

    def bf16_ratio(got, want16, want32):
        """Largest |card - CPU| of the bf16 run over BF16_FWD (outputs) or
        BF16_GRAD (gradients) of the scale plus the CPU's own bf16-vs-fp32
        gap at each entry."""
        worst = 0.0
        for kind, rel in (("outputs", BF16_FWD), ("grads", BF16_GRAD)):
            for k, w in want16[kind].items():
                tol = rel * w.abs().max() + (w - want32[kind][k]).abs() + 1e-30
                worst = max(worst, ((got[kind][k] - w).abs() / tol).max().item())
        return worst

    def fp32_check(got, want, slack, out_slack):
        """The fp32 check as ratios to their bounds, each tensor on its own
        (pass: every ratio <= 1): an output by its largest gap over FWD_TOL
        of its scale plus out_slack; a gradient of fewer than SMALL_LEAF
        entries by its largest gap over GRAD_TOL of its scale plus slack; a
        larger gradient by the share of its entries beyond that bound, over
        GRAD_SHARE. Returns the worst ratio, its tensor and the three
        worst."""
        ratios = {f"output:{k}": ((got["outputs"][k] - w).abs().max()
                                  / (FWD_TOL * w.abs().max() + out_slack[k] + 1e-30)).item()
                  for k, w in want["outputs"].items()}
        for k, w in want["grads"].items():
            beyond = (got["grads"][k] - w).abs() / (GRAD_TOL * w.abs().max() + slack[k] + 1e-30)
            ratios[k] = (beyond.max().item() if w.numel() < SMALL_LEAF
                         else (beyond > 1).double().mean().item() / GRAD_SHARE)
        worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
        return {"of_bound": worst[0][1], "name": worst[0][0], "worst": dict(worst)}

    def ulp_moved(make, inputs, sign):
        """make() and copies of the inputs, every weight and input entry
        moved one ulp (move_one_ulp's coins)."""
        def moved():
            mod = make()
            move_one_ulp(torch, list(mod.parameters()), sign)
            return mod
        xs = [x.clone() for x in inputs]
        move_one_ulp(torch, xs, sign)
        return moved, xs

    def f64_gap(got, want):
        return max(((got[k][n] - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
                   for k in ("outputs", "grads") for n, w in want[k].items())

    cnn_cfg = dict(in_channels=3, image_hw=(h, w), low_dim=cm["low_dim"])

    def unet_outputs(res):
        out, voxel_list = res
        return {"out": out, "skip25": voxel_list[1], "skip50": voxel_list[2]}

    def keypoints(mod, x, lang=None):
        return SpatialSoftmax2D()(mod._trunk(x, lang))

    models = {
        "cnn_lang_and_fcs": (seeded(lambda: CNNLangAndFcsNet(lang_dim=cm["lang_dim"], **cnn_cfg), 20),
                             [images, low, lang_vec],
                             lambda mod, xs: {"out": mod(*xs),
                                              "keypoints": keypoints(mod, xs[0], xs[2])}),
        "cnn_and_fcs": (seeded(lambda: CNNAndFcsNet(**cnn_cfg), 21), [images, low],
                        lambda mod, xs: {"out": mod(*xs), "keypoints": keypoints(mod, xs[0])}),
        "siamese": (seeded(lambda: SiameseNet(3), 22), [images, images.flip(1)],
                    lambda mod, xs: {"out": mod(xs)}),
        "vl_transformer": (seeded(lambda: Visual3DLangTransformer(cm["vl_tokens"][1],
                                                                  cm["lang_dim"]), 23),
                           [visual, lang_tok], lambda mod, xs: {"out": mod(*xs)}),
        "language_gate": (seeded(lambda: LanguageInformedVisualAttention(d0_cpu.shape[-1],
                                                                         cm["lang_dim"]), 24),
                          [d0_cpu, pooled], lambda mod, xs: {"out": mod(*xs)}),
        "unet_train": (seeded(lambda: MultiLayer3DEncoder(vox_cpu.shape[-1]), 25), [vox_cpu],
                       lambda mod, xs: unet_outputs(mod(xs[0], train=True))),
        "unet_eval": (seeded(lambda: MultiLayer3DEncoder(vox_cpu.shape[-1]), 25), [vox_cpu],
                      lambda mod, xs: unet_outputs(mod(xs[0]))),
    }
    make16 = seeded(lambda: Visual3DLangTransformer(cm["vl_tokens"][1], cm["lang_dim"],
                                                    dtype=torch.bfloat16), 23)
    results = {}
    for name, (make, inputs, call) in models.items():
        buffers, cots = name.startswith("unet"), {}
        want = on_cpu(lambda: first_pass(make, inputs, call, cpu, buffers=buffers, cots=cots))
        want64 = on_cpu(lambda: first_pass(make, inputs, call, cpu, torch.float64, buffers,
                                           cots))
        # each fp32 bound widens by ULP_K times the part's own fp32 error, its
        # gap to float64 on the CPU (phase 11's rule; read on the CPU only):
        # ReLU and leaky-ReLU kinks that rounding moves across, and the
        # T = 0.01 softmax of the keypoints, set those gaps; float64 card vs
        # CPU (F64_TOL), where rounding moves no kink, is the tight check. A
        # gradient's bound widens by the larger of that and ULP_K times its
        # response on the CPU to a one-ulp move of every weight and input
        # (up, then down; phase 10's rule, inputs added): one kink that the
        # card's rounding moves across moves a whole row of a weight's
        # gradient, and all of a bias
        f64_slack = {k: ULP_K * (w - want64["grads"][k]).abs().max()
                     for k, w in want["grads"].items()}
        out_slack = {k: ULP_K * (w - want64["outputs"][k]).abs().max()
                     for k, w in want["outputs"].items()}
        moved = [on_cpu(lambda: first_pass(*ulp_moved(make, inputs, sign), call, cpu,
                                           buffers=buffers, cots=cots))["grads"]
                 for sign in (1, -1)]
        ulp_slack = {k: ULP_K * max((m[k] - w).abs().max() for m in moved)
                     for k, w in want["grads"].items()}
        slack = {k: torch.maximum(f64_slack[k], ulp_slack[k]) for k in f64_slack}
        del moved
        got = first_pass(make, inputs, call, dev, buffers=buffers, cots=cots, time_it=True)
        got64 = first_pass(make, inputs, call, dev, torch.float64, buffers, cots)
        with tf32(torch, True):
            got_tf32 = first_pass(make, inputs, call, dev, buffers=buffers, cots=cots)
        ratios = {**{k: (slack[k] / (GRAD_TOL * w.abs().max() + 1e-30)).item()
                     for k, w in want["grads"].items()},
                  **{k: (out_slack[k] / (FWD_TOL * w.abs().max() + 1e-30)).item()
                     for k, w in want["outputs"].items()}}
        tf32_changed = any(not torch.equal(got_tf32[kind][k], got[kind][k])
                           for kind in ("outputs", "grads") for k in got[kind])

        def check(res):
            return fp32_check(res, want, slack, out_slack)

        r = dict(check=check(got), planted_tf32=check(got_tf32) if tf32_changed else "no-op",
                 gaps_unwidened=update_gaps(torch, got, want, 0.0),
                 slack_of_tol=dict(sorted(ratios.items(),
                                         key=lambda kv: -kv[1])[:3]),
                 float64_max_gap_of_scale=f64_gap(got64, want64), fwd_bwd_ms=got["ms"])
        del got64, got_tf32
        if name == "cnn_and_fcs":
            same_pads = encoder2d._same_pads
            encoder2d._same_pads = lambda n_, k_, s_: (k_ // 2, k_ // 2)
            try:
                r["planted_symmetric_padding"] = check(
                    first_pass(make, inputs, call, dev, cots=cots))
            finally:
                encoder2d._same_pads = same_pads
        if name == "vl_transformer":
            want16 = on_cpu(lambda: first_pass(make16, inputs, call, cpu, cots=cots))
            got16 = first_pass(make16, inputs, call, dev, cots=cots, time_it=True)
            r["bf16_of_bound"] = bf16_ratio(got16, want16, want)
            r["bf16_fwd_bwd_ms"] = got16["ms"]
            exact = types.SimpleNamespace(gelu=lambda x, approximate="none": F.gelu(x))
            vl_attention.F, tanh_f = exact, vl_attention.F
            try:
                r["planted_exact_gelu_float64_of_tol"] = f64_gap(
                    first_pass(make, inputs, call, dev, torch.float64, cots=cots),
                    want64) / F64_TOL
            finally:
                vl_attention.F = tanh_f
        results[name] = r
        del want, want64, got
        gc.collect()
        torch.cuda.empty_cache()

    # augment: the SAC pixel batch of phase 10 e, the CPU's draws fed to the card
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.uniform(0, 1, (SAC_BATCH, SAC_HW, SAC_HW, 3)).astype(np.float32))
    ga = torch.Generator().manual_seed(12)
    offsets = [torch.randint(0, 9, (SAC_BATCH,), generator=ga) for _ in range(2)]
    factors = [1.0 + (torch.rand((SAC_BATCH, 1, 1, 1), generator=ga) * 0.8 - 0.4)
               for _ in range(3)]
    coin = torch.rand((SAC_BATCH, 1, 1, 1), generator=ga)
    pixels_dev = pixels.to(dev)
    aug = {}
    for name, fn in (("random_shift", lambda x: augment.random_shift(x, 4, offsets=offsets)),
                     ("color_jitter", lambda x: augment.color_jitter(x, factors=factors)),
                     ("random_grayscale", lambda x: augment.random_grayscale(x, 0.2, u=coin))):
        want = fn(pixels)
        got = fn(pixels_dev).cpu()
        aug[name] = {"equal": bool(torch.equal(got, want)),
                     "max_gap": (got - want).abs().max().item(),
                     "ms": median_ms(torch, lambda: fn(pixels_dev), 10)}
    emit("camera_models", **results, augment=aug, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL,
         bf16_fwd=BF16_FWD, bf16_grad=BF16_GRAD, f64_tol=F64_TOL,
         cpu_reference_s=cpu_s[0], card=card)
    for name, r in results.items():
        if not (r["check"]["of_bound"] <= 1.0 and r["float64_max_gap_of_scale"] <= F64_TOL):
            fail(f"camera_models {name}: card vs CPU {r['check']}, "
                 f"float64 {r['float64_max_gap_of_scale']}")
        if r["planted_tf32"] != "no-op" and not r["planted_tf32"]["of_bound"] > 1.0:
            fail(f"camera_models {name}: the fp32 check does not see TF32 on "
                 f"({r['planted_tf32']})")
    if all(r["planted_tf32"] == "no-op" for r in results.values()):
        fail("camera_models: TF32 on changed no model's fp32 result")
    cnn = results["cnn_and_fcs"]["planted_symmetric_padding"]
    if not cnn["of_bound"] > 10:
        fail(f"camera_models: symmetric padding not seen by 10x its bound ({cnn})")
    vl = results["vl_transformer"]
    if not vl["bf16_of_bound"] <= 1.0:
        fail(f"camera_models vl_transformer: bf16 {vl['bf16_of_bound']} of its bound")
    if not vl["planted_exact_gelu_float64_of_tol"] > 10:
        fail(f"camera_models: exact GELU not seen by 10x its bound "
             f"({vl['planted_exact_gelu_float64_of_tol']})")
    if not all(a["equal"] for a in aug.values()):
        fail(f"camera_models: augmentations on the card differ from the CPU's {aug}")

    # --------------------------------------------------------- c. camera_ops
    g = torch.Generator(device=dev).manual_seed(13)
    ops = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        grid = torch.randn(FASTBWD["grid"], generator=g, device=dev).to(dtype)
        coords = torch.rand((1, FASTBWD["samples"], 3), generator=g, device=dev) * 2 - 1
        cot = torch.randn((1, FASTBWD["samples"], FASTBWD["grid"][-1]), generator=g,
                          device=dev).to(dtype)
        fast, auto = grid.clone().requires_grad_(), grid.clone().requires_grad_()
        out_f, out_a = grid_sample_3d_fastbwd(fast, coords), grid_sample_3d(auto, coords)
        (gf,) = torch.autograd.grad(out_f, fast, cot, retain_graph=True)
        (g_a,) = torch.autograd.grad(out_a, auto, cot, retain_graph=True)
        err = ((gf.float() - g_a.float()).abs().max() / g_a.float().abs().max()).item()
        ops[f"fastbwd_{dname}"] = dict(
            forward_equal=bool(torch.equal(out_f, out_a)), grad_gap_of_scale=err,
            tol=FASTBWD_TOL[dname],
            fastbwd_device_ms=profiled_ms(torch, lambda: torch.autograd.grad(
                out_f, fast, cot, retain_graph=True), 5),
            autograd_device_ms=profiled_ms(torch, lambda: torch.autograd.grad(
                out_a, auto, cot, retain_graph=True), 5))
        del grid, fast, auto, out_f, out_a, gf, g_a
        torch.cuda.empty_cache()
    n_rays, k_s = COMPOSITE["rays"], COMPOSITE["samples"]
    z = torch.rand((n_rays, k_s), generator=g, device=dev) * 2.8 + 1.2
    rays = torch.cat([torch.randn((n_rays, 3), generator=g, device=dev),
                      F.normalize(torch.randn((n_rays, 3), generator=g, device=dev), dim=-1),
                      torch.full((n_rays, 1), 1.2, device=dev),
                      torch.full((n_rays, 1), 4.0, device=dev)], -1)
    rgbs = torch.rand((n_rays, k_s, 3), generator=g, device=dev)
    sig = torch.rand((n_rays, k_s), generator=g, device=dev) * 3
    emb = torch.randn((n_rays, k_s, 512), generator=g, device=dev)
    order = torch.argsort(z, dim=-1, stable=True)

    def sorted_path():
        return composite(torch.gather(z, 1, order), rays,
                         torch.gather(rgbs, 1, order[..., None].expand_as(rgbs)),
                         torch.gather(sig, 1, order),
                         torch.gather(emb, 1, order[..., None].expand_as(emb)))

    srt, uns = sorted_path(), composite_unsorted(z, rays, rgbs, sig, emb)
    comp_gap = max(((a - b).abs().max() / b.abs().max()).item() for a, b in (
        (torch.gather(uns.weights, 1, order), srt.weights), (uns.rgb, srt.rgb),
        (uns.embed, srt.embed), (uns.depth, srt.depth)))
    ops["composite_unsorted"] = dict(
        gap_of_scale=comp_gap, tol=COMPOSITE_TOL,
        device_ms=profiled_ms(torch, lambda: composite_unsorted(z, rays, rgbs, sig, emb), 10),
        sorted_device_ms=profiled_ms(torch, sorted_path, 10))
    emit("camera_ops", **ops, grid=list(FASTBWD["grid"]), samples=FASTBWD["samples"],
         rays=n_rays, samples_per_ray=k_s, card=card)
    for dname in ("float32", "bfloat16"):
        o = ops[f"fastbwd_{dname}"]
        if not (o["forward_equal"] and o["grad_gap_of_scale"] <= o["tol"]):
            fail(f"camera_ops fastbwd {dname}: {o}")
    if not comp_gap <= COMPOSITE_TOL:
        fail(f"camera_ops composite_unsorted: {comp_gap} of the scale")

    # -------------------------------------------------------- d. camera_tools
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        summary = profile_policy.main(["--n-inner", "2", "--top", "10", "--out", tmp])
    profile_s = time.perf_counter() - t
    saved_dir, saved_lib = _build.BUILD_DIR, _build._LOADED.pop("corner_lerp", None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            where = enable_persistent_cache(os.path.join(tmp, "kernels"))
            rows = torch.randn((4096, 8 * 64), generator=g, device=dev).to(torch.bfloat16)
            w8 = torch.rand((8, 4096), generator=g, device=dev)
            lerp_gap = (corner_lerp(rows, w8).float() - corner_lerp_plain(rows, w8).float()
                        ).abs().max().item()
            built = sorted(os.path.basename(p) for p in os.listdir(where))
            cache_s = time.perf_counter() - t
    finally:
        _build.BUILD_DIR = saved_dir
        if saved_lib is not None:
            _build._LOADED["corner_lerp"] = saved_lib
    emit("camera_tools", profile_policy_device_ms=summary["device_ms_per_forward"],
         profile_policy_top_classes=summary["by_class"][:6],
         profile_policy_top_ops=summary["top"][:5], profile_policy_s=profile_s,
         cache_dir_built=built, cache_build_s=cache_s, corner_lerp_gap=lerp_gap,
         phase_wall_s=time.perf_counter() - t_phase, phase_cpu_reference_s=cpu_s[0], card=card)
    if not summary["device_ms_per_forward"] > 0 or not summary["by_class"]:
        fail(f"camera_tools: profile_policy saw no device time ({summary})")
    if not any(b.startswith("libcorner_lerp-") and b.endswith(".so") for b in built):
        fail(f"camera_tools: the kernel did not build in the cache directory ({built})")
    if not lerp_gap <= 2 ** -8 * rows.float().abs().max().item():
        fail(f"camera_tools: corner_lerp from the cache directory is off by {lerp_gap}")


def setting_b(fp32=False):
    """configs/nerfact.yaml in setting b: conv_backend "pallas", fused_gather
    true (with FUSED_LERP_BACKEND "pallas" set by the caller); in fp32 with
    fp32."""
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    base = from_dict(NerfActConfig, NERFACT)
    model = dataclasses.replace(base.peract.model, conv_backend="pallas")
    field = base.renderer.field
    if fp32:
        model = dataclasses.replace(model, compute_dtype="float32")
        field = dataclasses.replace(field, compute_dtype="float32")
    return dataclasses.replace(
        base, peract=dataclasses.replace(base.peract, model=model),
        renderer=dataclasses.replace(base.renderer, fused_gather=True, field=field))


def with_parallel32_optim(cfg):
    """`cfg` (a NerfActConfig) with the fp32 legs' optimizer."""
    from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig

    train = dataclasses.replace(cfg.peract.train, optim=OptimConfig(**PARALLEL32_OPTIM))
    return dataclasses.replace(cfg, peract=dataclasses.replace(cfg.peract, train=train))


def noisy_weights(torch, sd, std, seed):
    """`sd` with every bias (1-D leaf but BatchNorm statistics) moved by
    N(0, std^2) and every ResnetFC block's zero-initialised Dense_1 weight
    redrawn at fan_in^-1/2, from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        v = v.detach().cpu()
        if v.dim() == 1 and v.is_floating_point() and "running" not in k:
            v = v + std * torch.randn(v.shape, generator=g)
        elif "ResnetBlockFC" in k and k.endswith("Dense_1.weight"):
            v = torch.randn(v.shape, generator=g) * v.shape[1] ** -0.5
        out[k] = v.clone()
    return out


def two_scene_batch(torch, tr):
    """The global batch of the parallel legs: synthetic_data's sample of the
    scene of seed 0 and of seed 1, stacked."""
    a, b = (next(tr.synthetic_data(batch_size=1, seed=s)) for s in (0, 1))
    return {k: torch.cat([a[k], b[k]]) for k in a}


def cpu32(t):
    """A copy of `t` in fp32 on the CPU (never an alias of a live tensor)."""
    import torch
    return t.detach().to("cpu", dtype=torch.float32, copy=True)


def step_record(torch, module, optimizer, metrics, sd=None, named=None, moments=None):
    """metrics, gradients and buffers (CPU, fp32) after a step; with `sd`
    (the weights before it) also the weights after it, each tensor's largest
    update and Adam's first moments, by name. `named` and `moments` give the
    whole parameters and moments where the module holds shards."""
    out = dict(metrics={k: v.item() for k, v in metrics.items()},
               buffers={k: cpu32(v) for k, v in module.named_buffers()})
    if sd is not None:
        named = named or {n: p.detach() for n, p in module.named_parameters()}
        out["params"] = {k: cpu32(v) for k, v in named.items()}
        out["update_scale"] = {k: (v.double() - sd[k].double()).abs().max().item()
                               for k, v in out["params"].items()}
        if moments is None:
            st = optimizer.adamw.state
            moments = {n: st[p]["exp_avg"] for n, p in zip(optimizer.names, optimizer.params)
                       if p in st}
        out["moments"] = {k: cpu32(v) for k, v in moments.items()}
    return out


def joint_leg(torch, tr, sd, batch, draws, mesh, tensor_parallel, timed=0, update=False,
              after=None):
    """One checked step of tr's joint step wrapped for `mesh` from weights
    `sd` (then `timed` more): metrics, whole gradients and buffers (CPU,
    fp32), with `update` the whole updates and Adam moments (step_record),
    what after(state, mesh) returns, kernel launches of the checked step,
    its host seconds, the timed steps' host ms, peak memory."""
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.parallel.mesh import gather_tensors
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import (
        _whole_optimizer_state, make_data_parallel_step, whole_grads)

    cuda = tr.device.type == "cuda"
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(sd)
    step, place_state, place_batch = make_data_parallel_step(
        tr.train_step, mesh, state, batch, tensor_parallel=tensor_parallel)
    state = place_state(state)
    local = place_batch(batch)
    counters = (("conv3d_k3", conv3d_k3, "wgmma_launches"),
                ("conv3d_k3_vjp", conv3d_k3, "vjp_calls"),
                ("corner_lerp", corner_lerp, "cuda_launches"),
                ("corner_lerp_vjp", corner_lerp, "vjp_calls"))
    for _, obj, attr in counters:
        setattr(obj, attr, 0)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, m = step(state, local, None, **draws)
    if cuda:
        torch.cuda.synchronize()
    named = moments = None
    if update:
        named = gather_tensors(mesh, {n: p.detach() for n, p in state.module.named_parameters()},
                               step.placements)
        opt = state.optimizer
        moments = {opt.names[i]: st["exp_avg"] for i, st in _whole_optimizer_state(
            mesh, opt, step.placements)["adamw"]["state"].items()}
    out = step_record(torch, state.module, state.optimizer, m, sd if update else None,
                      named, moments)
    out.update(step_s=time.perf_counter() - t,
               launches={k: getattr(obj, attr) for k, obj, attr in counters},
               grads={k: cpu32(v) for k, v in
                      whole_grads(mesh, state.module, step.placements).items()},
               sharded=len(step.placements))
    if after is not None:
        out.update(after(state, mesh))
    times = []
    for _ in range(timed):
        t = time.perf_counter()
        step(state, local, None, **draws)
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["timed_ms"] = times
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def planted(fault):
    """A fault the parallel checks must see: k|v cut contiguously, a
    row-parallel bias added on every rank, BatchNorm statistics left local,
    the clip's norm over this rank's shards only, the non-finite flag left
    local."""
    import torch
    import torch.nn.functional as F

    from real_robot_nerf_actor_tpu_torch.convert import Placement
    from real_robot_nerf_actor_tpu_torch.models import blocks
    from real_robot_nerf_actor_tpu_torch.parallel import mesh as pmesh
    from real_robot_nerf_actor_tpu_torch.parallel import train_dp
    from real_robot_nerf_actor_tpu_torch.parallel.constraints import replicated

    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "kv_contiguous":
        plan = dict(pmesh._PLAN["attention"], **{"to_kv.weight": Placement("column")})
        patch(pmesh, "_PLAN", dict(pmesh._PLAN, attention=plan))
    elif fault == "bias_every_rank":
        def bias_every_rank(dense, x):
            dt = blocks._dtype_for(x, dense.weight, dense.dtype)
            b = None if dense.bias is None else dense.bias.to(dt)
            return replicated(F.linear(x.to(dt), dense.weight.to(dt), b))
        patch(pmesh.RowParallelDense, "forward", bias_every_rank)
    elif fault == "bn_local":
        patch(train_dp.DataParallelBatchNorm, "batch_moments", blocks.BatchNorm.batch_moments)
    elif fault == "clip_local":
        patch(train_dp.GradSync, "global_norm",
              lambda self, norms: torch.linalg.vector_norm(norms))
    elif fault == "finite_local":
        patch(train_dp.GradSync, "all_finite", lambda self, finite: finite)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def nonfinite_check(state, mesh):
    """GradSync's non-finite flag on the card: rank 1's first gradient made
    NaN, then one step of a fresh unclipped optimizer over this rank's
    shards (with the flag reduced over every rank, then with it planted
    local); whether the update ran and moved the weights, which are put
    back after. The flag reduced, no rank may step; left local, rank 0
    steps while rank 1 skips (no collective follows the flag without a
    clip, so the ranks do not wait on each other)."""
    import torch

    from real_robot_nerf_actor_tpu_torch.train.trainer import Optimizer

    out = {}
    for fault in (None, "finite_local"):
        opt = Optimizer(dataclasses.replace(state.optimizer.cfg, grad_clip=0.0),
                        state.module.named_parameters())
        opt.sync = state.optimizer.sync
        before = [q.detach().clone() for q in opt.params]
        p0, g0 = opt.params[0], opt.params[0].grad
        if mesh.rank == 1:
            p0.grad = torch.zeros_like(p0) if g0 is None else g0.clone()
            p0.grad.view(-1)[0] = float("nan")
        with planted(fault):
            stepped = opt.step()
        p0.grad = g0
        moved = any(not torch.equal(a, q) for a, q in zip(before, opt.params))
        with torch.no_grad():
            for a, q in zip(before, opt.params):
                q.copy_(a)
        out[str(fault)] = dict(stepped=bool(stepped), moved=moved)
    return {"nonfinite": out}


def policy_forward(torch, net, vox, proprio, lang):
    """(q_trans, q_rot_grip, q_collision) in fp32 on the CPU, the decoded
    (coords, rot_grip, collision), and the latents entering the decoder's
    cross-attention, of one forward."""
    from real_robot_nerf_actor_tpu_torch.ops import choose_highest_action

    seen = {}
    hook = net.decoder_cross_attn.register_forward_hook(
        lambda mod, args, out: seen.update(latents=cpu32(args[1])))
    try:
        with torch.inference_mode():
            out = net(vox, proprio, lang)
            dec = choose_highest_action(out[0], out[1], out[2])
    finally:
        hook.remove()
    return [o.float().cpu() for o in out[:3]], [d.cpu() for d in dec], seen["latents"]


def tiny_slack_inputs(torch, tr):
    """The CPU reorder check's weights, batch and draws at the dryrun's tiny
    width: seed 0 with the parallel legs' bias noise, the scenes of
    seeds 0 and 1 cut to max_num_coords, draws from a generator of seed 1."""
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import global_draws

    sd = noisy_weights(torch, tr.init_state(torch.Generator().manual_seed(0)).module.state_dict(),
                       PARALLEL_BIAS_STD, 3)
    ncap = tr.cfg.voxelizer.max_num_coords
    batch = {k: v[:, :ncap] if k in ("points", "colors", "valid") else v
             for k, v in two_scene_batch(torch, tr).items()}
    return sd, batch, global_draws(tr, 2, torch.Generator().manual_seed(1))


def parallel_rank(rank, world, port, in_path, out_dir):
    """A rank of phase 13's two-rank legs, on card 0 over gloo: b (dp 2) and
    c (tp 2) of the joint step with their planted faults, the same in fp32
    (b32, c32; c32 with the clip fault and the non-finite flag), d (the tp 2
    policy forward) with its faults, then the CPU's reorder check at the
    dryrun's tiny width (bf16 and fp32). Leaves rank{rank}.pt in out_dir."""
    import torch

    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    from real_robot_nerf_actor_tpu_torch.models.blocks import Conv3DBlock
    from real_robot_nerf_actor_tpu_torch.ops import grid_sample
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
    from real_robot_nerf_actor_tpu_torch.parallel import (
        MeshSpec, make_mesh, shard_module_, shard_params_rule, tensor_parallel)
    from real_robot_nerf_actor_tpu_torch.parallel.dryrun import gate_config
    from real_robot_nerf_actor_tpu_torch.parallel.mesh import init_rank
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(in_path, weights_only=False)
    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    init_rank(rank, world, port, "gloo", timeout_s=PARALLEL_DEADLINE_S)
    grid_sample.FUSED_LERP_BACKEND = "pallas"
    res = {}
    meshes = {"b": make_mesh(MeshSpec(data=2, model=1)), "c": make_mesh(MeshSpec(data=1, model=2))}
    tr = NerfActTrainer(setting_b(), device=dev)
    batch = {k: v.to(dev) for k, v in inp["batch"].items()}
    draws = {"draws": inp["draws"]["draws"].to(dev), "ray_idx": inp["draws"]["ray_idx"],
             "render_draws": inp["draws"]["render_draws"]}
    for leg, faults in (("b", (None, "bn_local")),
                        ("c", (None, "kv_contiguous", "bias_every_rank"))):
        for fault in faults:
            with planted(fault), deterministic_algorithms(torch):
                r = joint_leg(torch, tr, inp["sd"], batch, draws, meshes[leg], leg == "c",
                              timed=PARALLEL_TIMED if fault is None else 0)
            if rank != 0:
                r = {k: v for k, v in r.items() if k not in ("grads", "buffers")}
            res[f"{leg}/{fault}"] = r
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    tr = NerfActTrainer(with_parallel32_optim(setting_b(fp32=True)), device=dev)
    for leg, faults in (("b32", (None,)), ("c32", (None, "clip_local"))):
        for fault in faults:
            check = nonfinite_check if leg == "c32" and fault is None else None
            with planted(fault), deterministic_algorithms(torch):
                r = joint_leg(torch, tr, inp["sd"], batch, draws, meshes[leg[0]], leg == "c32",
                              update=True, after=check)
            if rank != 0:
                r = {k: v for k, v in r.items()
                     if k not in ("grads", "buffers", "params", "moments")}
            res[f"{leg}/{fault}"] = r
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()

    # d: serve.yaml's policy, tp 2 over the heads and FF hidden, flash on the
    # local heads; the one-rank forward first (rank 0)
    vox, proprio, lang = (inp["policy_in"][k].to(dev) for k in ("vox", "proprio", "lang"))

    def policy():
        net = PerceiverIO(inp["policy_cfg"])
        net.load_state_dict(inp["policy_sd"])
        net.to(dev).eval()
        for m in net.modules():
            if isinstance(m, Conv3DBlock):
                m.cast_kernel_()
        return net

    if rank == 0:
        res["d/one_rank"] = policy_forward(torch, policy(), vox, proprio, lang)
    for fault in (None, "kv_contiguous", "bias_every_rank"):
        with planted(fault):
            net = policy()
            shard_module_(meshes["c"], net, shard_params_rule(meshes["c"], net))
            for obj, attr in ((flash_attention, "wgmma_launches"),
                              (spatial_stats_3d, "cuda_launches"),
                              (conv3d_k3, "wgmma_launches")):
                setattr(obj, attr, 0)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with tensor_parallel(meshes["c"]):
                out = policy_forward(torch, net, vox, proprio, lang)
            res[f"d/{fault}"] = dict(
                out=out, s=time.perf_counter() - t,
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches={"flash_attention": flash_attention.wgmma_launches,
                          "spatial_stats_3d": spatial_stats_3d.cuda_launches,
                          "conv3d_k3": conv3d_k3.wgmma_launches})
            del net
    torch.cuda.empty_cache()

    # the CPU's own reordering of the two-rank sums: the dryrun's tiny config
    # in bf16, as the card's legs compute, each leg's gradients and
    # statistics against the one-rank step
    tiny = gate_config("tiny")
    tiny = dataclasses.replace(
        tiny, peract=dataclasses.replace(tiny.peract, model=dataclasses.replace(
            tiny.peract.model, compute_dtype="bfloat16")),
        renderer=dataclasses.replace(tiny.renderer, field=dataclasses.replace(
            tiny.renderer.field, compute_dtype="bfloat16")))
    for suffix, cfg in (("", tiny), ("32", with_parallel32_optim(gate_config("tiny")))):
        cpu_tr = NerfActTrainer(cfg, device="cpu")
        sd, batch, draws = tiny_slack_inputs(torch, cpu_tr)
        if rank == 0:
            st = cpu_tr.init_state(torch.Generator().manual_seed(0))
            st.module.load_state_dict(sd)
            st, m1 = cpu_tr.train_step(st, batch, None, **draws)
            res[f"cpu/one_rank{suffix}"] = dict(
                step_record(torch, st.module, st.optimizer, m1, sd if suffix else None),
                grads={n: cpu32(p.grad) for n, p in st.module.named_parameters()})
        for leg in ("b", "c"):
            res[f"cpu/{leg}{suffix}"] = joint_leg(torch, cpu_tr, sd, batch, draws, meshes[leg],
                                                  leg == "c", update=bool(suffix))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def entry_gaps(got, want, kind, skip=()):
    """{name: each entry's gap of `kind` ("grads", "moments" or "params"),
    of its tensor's scale}. "params" are the weights after the step
    (step_record): the gap beyond one ulp of the stored weight (two updates
    a hair apart may round to neighbouring fp32 weights), of the tensor's
    largest update."""
    import torch

    out = {}
    for k, w in want[kind].items():
        if k in skip:
            continue
        gap = (got[kind][k] - w).abs()
        if kind == "params":
            gap = (gap - (torch.nextafter(w.abs(), torch.tensor(math.inf)) - w.abs())).clamp_min(0)
            out[k] = gap / max(want["update_scale"][k], 1e-30)
        else:
            out[k] = gap / w.abs().max().clamp_min(1e-30)
    return out


def rel_gaps(got, want, skip=()):
    """max |got - want| / max |want| of each tensor of `want` (a 1e-30 floor)."""
    return {k: ((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for k, w in want.items() if k not in skip}


def parallel_phase(torch, np, dev, card, policy, vox, proprio, lang):
    """Phase 13: configs/nerfact.yaml's joint step in setting b at full
    width over a global batch of two, on parallel/ (see the module
    constants for the inputs).

      a. make_data_parallel_step at world size 1 over NCCL against the bare
         step: loss, every gradient and the BatchNorm statistics equal (on
         deterministic algorithms); the wrapper's host p50 and device ms a
         step beside the bare step's (in turns); the same step in fp32 for
         the tolerance.
      b. dp 2 x tp 1: two ranks on cuda:0 over gloo, one sample each, sample
         0's d0 and view broadcast and 256 of the 512 rays a rank;
      c. dp 1 x tp 2: the policy's self-attention heads and GEGLU hidden and
         the field's block hidden cut over two ranks;
         b and c against a's one-rank step on the same batch and draws:
         every gradient within max(a's bf16-vs-fp32 gap, 2^-7) of its scale
         (phase 7's rule), the loss within the same rule, the BatchNorm
         statistics within BN_TOL, each widened by the largest gap the
         CPU's own reordering of the two-rank sums moves the leg at the
         dryrun's tiny width in bf16 (read on the CPU, never from the card).
         Planted: BatchNorm statistics left local must fail b; k|v cut
         contiguously and the row-parallel bias added on both ranks must
         fail c.
      b32, c32. b and c in fp32 under PARALLEL32_OPTIM, against the fp32
         one-rank step of a: the gradients, the weights after the step
         (beyond one ulp), Adam's first moments (the clipped gradient)
         and the loss within FP32_K times the CPU's own fp32 reordering gap
         of the same leg at the dryrun's tiny width plus ULP_K times the
         tensor's one-ulp response in a's fp32 step (a tensor of SMALL_LEAF
         entries or more: at most GRAD_SHARE of them beyond it), the
         statistics within BN_TOL plus that gap. Planted: the clip's norm over this rank's
         shards must fail c32. c32 also holds GradSync's non-finite flag:
         a NaN in rank 1's gradient, no rank steps; the flag left local,
         rank 0 steps alone.
      d. tp 2 forward of serve.yaml's policy (phase 3's, kernel knobs on,
         flash_attention on the local heads): decoded actions equal the one
         rank's, the logits within ACT_TOL of their scale and the latents
         entering the decoder within LATENT_TOL (RMS); the two TP faults
         must fail that.
    The two-rank legs' times measure host staging of gloo's collectives on
    one card, not scaling; multi-card runs are not verified here."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    import torch.distributed as dist
    from real_robot_nerf_actor_tpu_torch.ops import grid_sample
    from real_robot_nerf_actor_tpu_torch.parallel import MeshSpec, make_mesh
    from real_robot_nerf_actor_tpu_torch.parallel.mesh import free_port, init_rank, run_ranks
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import render_draws
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer

    t_phase = time.perf_counter()
    grid_sample.FUSED_LERP_BACKEND = "pallas"
    tr = NerfActTrainer(setting_b(), device=dev)
    sd = noisy_weights(torch, tr.init_state(torch.Generator().manual_seed(0)).module.state_dict(),
                       PARALLEL_BIAS_STD, 3)
    batch = two_scene_batch(torch, tr)
    rc = tr.jcfg.renderer
    g = torch.Generator().manual_seed(1)
    draws = dict(draws=torch.tensor([[0.37, -0.61, 0.18], [-0.52, 0.44, -0.27]]),
                 ray_idx=torch.randint(0, rc.image_height * rc.image_width,
                                       (rc.ray_chunk_size,), generator=g),
                 render_draws=render_draws(rc, True, rc.ray_chunk_size, g))
    draws_dev = dict(draws, draws=draws["draws"].to(dev))

    # ---- a: one rank over NCCL, the wrapper against the bare step
    init_rank(0, 1, free_port(), "nccl")
    mesh = make_mesh(MeshSpec(data=1, model=1))
    with deterministic_algorithms(torch):
        bare_state = tr.init_state(torch.Generator().manual_seed(0))
        bare_state.module.load_state_dict(sd)
        bare_state, m_bare = tr.train_step(bare_state, batch, None, **draws_dev)
        bare = dict(metrics={k: v.item() for k, v in m_bare.items()},
                    grads={n: cpu32(p.grad) for n, p in bare_state.module.named_parameters()},
                    buffers={k: cpu32(v) for k, v in bare_state.module.named_buffers()})
        wrapped = joint_leg(torch, tr, sd, batch, draws_dev, mesh, False)
    equal = (wrapped["metrics"] == bare["metrics"]
             and all(torch.equal(wrapped["grads"][k], v) for k, v in bare["grads"].items())
             and all(torch.equal(wrapped["buffers"][k], v) for k, v in bare["buffers"].items()))
    # host and device time a step, bare and wrapped in turns
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import make_data_parallel_step
    w_state = tr.init_state(torch.Generator().manual_seed(0))
    w_state.module.load_state_dict(sd)
    w_step, place_state, _ = make_data_parallel_step(tr.train_step, mesh, w_state, batch)
    w_state = place_state(w_state)
    runs = {"bare": lambda: tr.train_step(bare_state, batch, None, **draws_dev),
            "wrapped": lambda: w_step(w_state, batch, None, **draws_dev)}
    host = {k: [] for k in runs}
    for i in range(1 + PARALLEL_TIMED):
        for name in (("bare", "wrapped") if i % 2 == 0 else ("wrapped", "bare")):
            t = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            if i:
                host[name].append((time.perf_counter() - t) * 1e3)
    device = {}
    for name, fn in runs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device[name] = sum(r[1] for r in device_rows(torch, prof))
    a_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del bare_state, w_state, w_step, runs
    dist.destroy_process_group()
    # the tolerance: the same bare step in fp32 (phase 7's rule), under the
    # fp32 legs' optimizer (the reference of b32 and c32)
    tr32 = NerfActTrainer(with_parallel32_optim(setting_b(fp32=True)), device=dev)
    with deterministic_algorithms(torch):
        st32 = tr32.init_state(torch.Generator().manual_seed(0))
        st32.module.load_state_dict(sd)
        st32, m32 = tr32.train_step(st32, batch, None, **draws_dev)
        ref32 = dict(step_record(torch, st32.module, st32.optimizer, m32, sd),
                     grads={n: cpu32(p.grad) for n, p in st32.module.named_parameters()})
        # the fp32 legs' widening: each tensor's largest response to a one-ulp
        # move of every weight (seeded coins, then turned over) in this
        # one-rank step, the reference the legs are held to (phase 10's rule)
        resp32 = {"grads": {}, "moments": {}, "loss": 0.0}
        for sign in (1, -1):
            st = tr32.init_state(torch.Generator().manual_seed(0))
            st.module.load_state_dict(sd)
            move_one_ulp(torch, list(st.module.parameters()), sign)
            st, m = tr32.train_step(st, batch, None, **draws_dev)
            st_adam = st.optimizer.adamw.state
            moved = {"grads": {n: cpu32(p.grad) for n, p in st.module.named_parameters()},
                     "moments": {n: cpu32(st_adam[p]["exp_avg"]) for n, p in
                                 zip(st.optimizer.names, st.optimizer.params) if p in st_adam}}
            for kind in ("grads", "moments"):
                for k, e in entry_gaps(moved, ref32, kind, ("policy." + INVARIANT,)).items():
                    resp32[kind][k] = max(resp32[kind].get(k, 0.0), e.max().item())
            resp32["loss"] = max(resp32["loss"], abs(m["loss_total"].item() - m32["loss_total"].item())
                                 / abs(m32["loss_total"].item()))
            del st, moved
        resp32["params"] = resp32["moments"]   # the update is lr * moment / (0.1 * eps)
    del st32, tr32
    tol = {k: max(v, 2 ** -7) for k, v in rel_gaps(bare["grads"], ref32["grads"],
                                                   skip=("policy." + INVARIANT,)).items()}
    loss_tol = max(abs(bare["metrics"]["loss_total"] - m32["loss_total"].item())
                   / abs(m32["loss_total"].item()), 2 ** -7)
    emit("parallel_a", equal_to_bare_step=equal, loss_total=bare["metrics"]["loss_total"],
         backend="nccl", world_size=1, host_p50_ms={k: statistics.median(v)
                                                    for k, v in host.items()},
         host_ms=host, device_ms=device, launches=wrapped["launches"], peak_gb=a_peak,
         tol_median=statistics.median(tol.values()), tol_max=max(tol.values()),
         loss_tol=loss_tol, card=card)
    if not equal:
        fail("parallel a: the world-size-1 step is not equal to the bare step")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- b, c, d: two ranks on cuda:0 over gloo
    with tempfile.TemporaryDirectory() as tmp:
        policy_sd = noisy_weights(torch, policy[1], POLICY_BIAS_STD, 4)
        torch.save(dict(device=str(dev), sd=sd, batch={k: v.cpu() for k, v in batch.items()},
                        draws=draws,
                        policy_cfg=policy[0], policy_sd=policy_sd,
                        policy_in=dict(vox=vox.cpu(), proprio=proprio.cpu(), lang=lang.cpu())),
                   os.path.join(tmp, "in.pt"))
        del batch, policy_sd
        gc.collect()
        t = time.perf_counter()
        run_ranks(parallel_rank, 2, (os.path.join(tmp, "in.pt"), tmp),
                  timeout_s=PARALLEL_DEADLINE_S)
        ranks_s = time.perf_counter() - t
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(2)]
    grid_sample.FUSED_LERP_BACKEND = "xla"
    r0 = res[0]
    cpu_ref = r0["cpu/one_rank"]
    skip = ("policy." + INVARIANT,)

    def slack(leg):
        got = r0[f"cpu/{leg}"]
        return (max(rel_gaps(got["grads"], cpu_ref["grads"], skip).values()),
                max(rel_gaps(got["buffers"], cpu_ref["buffers"]).values()),
                abs(got["metrics"]["loss_total"] - cpu_ref["metrics"]["loss_total"])
                / abs(cpu_ref["metrics"]["loss_total"]))

    def check(got, sl):
        """(worst ratio of gap to bound over gradients, loss and statistics;
        its tensor; the gaps)."""
        gp = rel_gaps(got["grads"], bare["grads"], skip)
        ratios = {k: gp[k] / (tol[k] + sl[0]) for k in gp}
        bn = max(rel_gaps(got["buffers"], bare["buffers"]).values())
        loss = (abs(got["metrics"]["loss_total"] - bare["metrics"]["loss_total"])
                / abs(bare["metrics"]["loss_total"]))
        ratios["buffers"] = bn / (BN_TOL + sl[1])
        ratios["loss_total"] = loss / (loss_tol + sl[2])
        worst = max(ratios, key=ratios.get)
        return ratios[worst], worst, dict(
            worst_gap=gp.get(worst), buffers_gap=bn, loss_gap=loss,
            median_grad_ratio=statistics.median(v for k, v in ratios.items()
                                                if k not in ("buffers", "loss_total")))

    for leg, faults in (("b", ("bn_local",)), ("c", ("kv_contiguous", "bias_every_rank"))):
        sl = slack(leg)
        ratio, worst, info = check(r0[f"{leg}/None"], sl)
        planted_f = {f: check(r0[f"{leg}/{f}"], sl)[:2] for f in faults}
        emit(f"parallel_{leg}", mesh={"b": {"data": 2, "model": 1},
                                      "c": {"data": 1, "model": 2}}[leg],
             backend="gloo", ranks_on_one_card=2,
             sharded_leaves=r0[f"{leg}/None"]["sharded"],
             loss_total=r0[f"{leg}/None"]["metrics"]["loss_total"],
             worst_gap_over_bound=ratio, worst=worst, **info,
             cpu_reorder_slack={"grads": sl[0], "buffers": sl[1], "loss": sl[2]},
             planted_faults={f: {"worst_gap_over_bound": x, "worst": w}
                             for f, (x, w) in planted_f.items()},
             per_rank=[{"first_step_s": r[f"{leg}/None"]["step_s"],
                        "timed_ms": r[f"{leg}/None"]["timed_ms"],
                        "peak_gb": r[f"{leg}/None"].get("peak_gb"),
                        "launches": r[f"{leg}/None"]["launches"]} for r in res],
             card=card)
        if not ratio <= 1.0:
            fail(f"parallel {leg}: {worst} is {ratio} x its bound")
        for f, (x, w) in planted_f.items():
            if not x > 1.0:
                fail(f"parallel {leg}: the check does not see the planted fault {f} ({x}, {w})")

    # b32, c32: the fp32 legs against the fp32 one-rank step
    cpu_ref32 = r0["cpu/one_rank32"]
    kinds32 = ("grads", "params", "moments")

    def loss_gap(got, want):
        return (abs(got["metrics"]["loss_total"] - want["metrics"]["loss_total"])
                / abs(want["metrics"]["loss_total"]))

    def slack32(leg):
        """The CPU's own fp32 reorder gap of `leg` at the tiny width: the
        largest entry gap of any kind and the loss; the statistics'."""
        got = r0[f"cpu/{leg}32"]
        gap = max([loss_gap(got, cpu_ref32)] + [
            e.max().item() for kind in kinds32
            for e in entry_gaps(got, cpu_ref32, kind, skip).values()])
        return gap, max(rel_gaps(got["buffers"], cpu_ref32["buffers"]).values())

    def check32(got, sl):
        """Ratios to each tensor's bound, FP32_K * sl[0] of its scale plus
        ULP_K times its one-ulp response (resp32): a tensor of fewer than
        SMALL_LEAF entries by its largest gap, a larger one by the share of
        its entries beyond the bound over GRAD_SHARE (phase 12's rule); the
        loss by its gap, the statistics over BN_TOL plus sl[1]. (worst
        ratio, its name, the worst by kind and the six worst.)"""
        bound = FP32_K * sl[0]
        ratios = {"loss_total": loss_gap(got, ref32) / (bound + ULP_K * resp32["loss"]),
                  "buffers": max(rel_gaps(got["buffers"], ref32["buffers"]).values())
                  / (BN_TOL + sl[1])}
        for kind in kinds32:
            for k, e in entry_gaps(got, ref32, kind, skip).items():
                b = bound + ULP_K * resp32[kind][k]
                ratios[f"{kind}:{k}"] = (e.max().item() / b if e.numel() < SMALL_LEAF
                                         else (e > b).double().mean().item() / GRAD_SHARE)
        top = sorted(ratios.items(), key=lambda kv: -kv[1])
        return top[0][1], top[0][0], dict(
            worst_by_kind={kind: max(v for k, v in ratios.items() if k.startswith(kind + ":"))
                           for kind in kinds32},
            worst=dict(top[:6]))

    failed = []
    for leg, faults in (("b32", ()), ("c32", ("clip_local",))):
        sl = slack32(leg[0])
        ratio, worst, info = check32(r0[f"{leg}/None"], sl)
        planted_f = {f: check32(r0[f"{leg}/{f}"], sl) for f in faults}
        nonfinite = [r[f"{leg}/None"].get("nonfinite") for r in res]
        emit(f"parallel_{leg}", mesh={"b32": {"data": 2, "model": 1},
                                      "c32": {"data": 1, "model": 2}}[leg],
             backend="gloo", ranks_on_one_card=2, dtype="float32", optim=PARALLEL32_OPTIM,
             loss_total=r0[f"{leg}/None"]["metrics"]["loss_total"],
             loss_one_rank=ref32["metrics"]["loss_total"],
             worst_gap_over_bound=ratio, worst_name=worst, **info,
             bound=FP32_K * sl[0], grad_share=GRAD_SHARE, ulp_k=ULP_K,
             ulp_response={kind: {"median": statistics.median(resp32[kind].values()),
                                  "max": max(resp32[kind].values())}
                           for kind in ("grads", "moments")} | {"loss": resp32["loss"]},
             cpu_fp32_reorder_slack={"tensors": sl[0], "buffers": sl[1]},
             planted_faults={f: {"worst_gap_over_bound": x, "worst_name": w,
                                 "worst_by_kind": i["worst_by_kind"]}
                             for f, (x, w, i) in planted_f.items()},
             nonfinite=nonfinite if nonfinite[0] else None,
             per_rank=[{"first_step_s": r[f"{leg}/None"]["step_s"],
                        "peak_gb": r[f"{leg}/None"].get("peak_gb")} for r in res],
             card=card)
        if not ratio <= 1.0:
            failed.append(f"parallel {leg}: {worst} is {ratio} x its bound")
        for f, (x, w, i) in planted_f.items():
            if not i["worst_by_kind"]["params"] > 1.0:   # the weights after the step
                failed.append(f"parallel {leg}: the check does not see the planted fault {f} "
                              f"({i['worst_by_kind']})")
        if nonfinite[0]:
            sound = [n["None"] for n in nonfinite]
            local = [n["finite_local"] for n in nonfinite]
            if any(x["stepped"] or x["moved"] for x in sound):
                failed.append(f"parallel {leg}: a rank stepped on a non-finite gradient "
                              f"({sound})")
            if not (local[0]["stepped"] and local[0]["moved"] and not local[1]["stepped"]):
                failed.append(f"parallel {leg}: the check does not see the non-finite flag "
                              f"left local ({local})")
    del ref32

    want_out, want_dec, want_lat = r0["d/one_rank"]

    def check_d(got):
        out, dec, lat = got["out"]
        gaps = {n: (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for n, a, b in zip(("q_trans", "q_rot_grip", "q_collision"), out, want_out)}
        same = all(torch.equal(a, b) for a, b in zip(dec, want_dec))
        latent = ((lat - want_lat).pow(2).mean().sqrt() / want_lat.pow(2).mean().sqrt()).item()
        return gaps, same, latent, (same and max(gaps.values()) <= ACT_TOL
                                    and latent <= LATENT_TOL)

    gaps_d, same_d, lat_d, ok_d = check_d(r0["d/None"])
    faults_d = {f: check_d(r0[f"d/{f}"]) for f in ("kv_contiguous", "bias_every_rank")}
    emit("parallel_d", mesh={"data": 1, "model": 2}, logit_gap_of_scale=gaps_d,
         decoded_equal=same_d, tol_of_scale=ACT_TOL, latent_rms_gap=lat_d,
         latent_tol=LATENT_TOL, decoded=[d.tolist() for d in want_dec],
         planted_faults={f: {"logit_gap_of_scale": g_, "decoded_equal": s_,
                             "latent_rms_gap": l_}
                         for f, (g_, s_, l_, _) in faults_d.items()},
         per_rank=[{"forward_s": r["d/None"]["s"], "peak_gb": r["d/None"]["peak_gb"],
                    "launches": r["d/None"]["launches"]} for r in res], card=card)
    if failed:
        fail("; ".join(failed))
    if not ok_d:
        fail(f"parallel d: the tp 2 forward leaves the one-rank forward ({gaps_d}, "
             f"decoded equal {same_d}, latents {lat_d})")
    for f, (_, _, _, ok) in faults_d.items():
        if ok:
            fail(f"parallel d: the check does not see the planted fault {f}")
    emit("parallel", ranks_s=ranks_s, phase_wall_s=time.perf_counter() - t_phase,
         note="two ranks share one card over gloo: their times measure host staging of "
              "the collectives, not scaling; multi-card runs are not verified", card=card)


def checkpoint_phase(torch, np, dev, card):
    """Phase 14: the tools that read a trained checkpoint, at full width.

    The port writes a kitchen of CKPT_DEMOS demos x CKPT_KEYFRAMES keyframes
    at configs/nerfact.yaml's widths and trains the file in setting b
    (conv3d_k3 and corner_lerp with their VJPs) on it for CKPT_STEPS steps
    through `train/nerfact.main` (--data-root, --ckpt-dir; the config as a
    JSON file: the card has no PyYAML). Then, on that checkpoint:
      - `train/serve.main --ckpt-dir --joint`: the served policy's logits
        on the first transition's voxels equal the trained module's (bit
        for bit, deterministic algorithms), and two act steps;
      - `tools/eval_quality.main` with every variant: the PSNRs of each (a
        field trained for CKPT_STEPS steps is not a learned field: they
        are not quality figures and are compared with nothing), and each
        kernel variant's frame (pallas_bf16, pallas_int8 and the int8
        serving variants) against the same variant's plain field
        (mlp_backend "xla": same weights, occupancy, plan and draws) within
        RGB_TOL and PSNR_MIN, the serving frame check; the launches of
        ray_expand, corner_lerp and both MLP kernels in each variant
        (its calibration and both views' frames);
      - `tools/analyze_bc.main` and `tools/extract_nerf_feat.main` once each.
    Fails on a logit that differs, a failed frame check, a kernel variant
    that launched none of its kernels, or a tool that does not run."""
    import tempfile

    from real_robot_nerf_actor_tpu_torch.data.kitchen import write_kitchen_demos
    from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource
    from real_robot_nerf_actor_tpu_torch.ops import grid_sample, voxelize
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
    from real_robot_nerf_actor_tpu_torch.ops.resnetfc_cuda import (
        fused_gather_resnetfc_int8, fused_resnetfc_int8)
    from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, psnr
    from real_robot_nerf_actor_tpu_torch.tools import analyze_bc, eval_quality, extract_nerf_feat
    from real_robot_nerf_actor_tpu_torch.train import nerfact, serve
    from real_robot_nerf_actor_tpu_torch.utils.config import to_dict

    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    kitchen, ckpt = os.path.join(tmp, "kitchen"), os.path.join(tmp, "ckpt")
    t = time.perf_counter()
    write_kitchen_demos(kitchen, n_demos=CKPT_DEMOS, n_keyframes=CKPT_KEYFRAMES,
                        image_hw=(128, 128), focal=76.18 * 128 / 80.0, d_embed=512)
    write_s = time.perf_counter() - t
    cfg = setting_b()
    cfg = dataclasses.replace(cfg, peract=dataclasses.replace(
        cfg.peract, train=dataclasses.replace(cfg.peract.train, ckpt_every=CKPT_STEPS,
                                              eval_every=10 ** 9, log_every=1)))
    cfg_path = os.path.join(tmp, "nerfact_b.json")
    with open(cfg_path, "w") as f:
        json.dump(to_dict(cfg), f)
    counters = {"flash_attention": (flash_attention, "wgmma_launches"),
                "spatial_stats_3d": (spatial_stats_3d, "cuda_launches"),
                "conv3d_k3": (conv3d_k3, "wgmma_launches"),
                "conv3d_k3_vjp": (conv3d_k3, "vjp_calls"),
                "corner_lerp": (corner_lerp, "cuda_launches"),
                "corner_lerp_vjp": (corner_lerp, "vjp_calls"),
                "ray_expand": (ray_expand, "cuda_launches"),
                # every design: the bf16 variants run the MLP on mma.sync
                "fused_resnetfc_int8": (fused_resnetfc_int8, "launches"),
                "fused_gather_resnetfc_int8": (fused_gather_resnetfc_int8, "launches")}

    def zero():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    grid_sample.FUSED_LERP_BACKEND = "pallas"
    zero()
    t = time.perf_counter()
    state = nerfact.main(["--config", cfg_path, "--data-root", kitchen, "--n-demos",
                          str(CKPT_DEMOS), "--steps", str(CKPT_STEPS), "--ckpt-dir", ckpt,
                          "--no-resume", "--device", str(dev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_launches = read()
    emit("checkpoint_train", steps=CKPT_STEPS, write_s=write_s, train_s=train_s,
         launches=train_launches, checkpoints=sorted(os.listdir(ckpt)), card=card)
    want = {"flash_attention": 0, "spatial_stats_3d": 0, "conv3d_k3": CKPT_STEPS,
            "conv3d_k3_vjp": CKPT_STEPS, "corner_lerp": 2 * CKPT_STEPS,
            "corner_lerp_vjp": 2 * CKPT_STEPS}
    if any(train_launches[k] != v for k, v in want.items()):
        fail(f"checkpoint: training launches {train_launches}, want {want}")

    # ---- serve the checkpoint's policy
    serve_argv = ["--ckpt-dir", ckpt, "--joint", "--config", cfg_path, "--steps", "2"]
    src = ReplaySource(kitchen, CKPT_DEMOS)
    tr, tr_state = eval_quality.restore_joint(cfg, ckpt, dev)
    cloud = eval_quality.cloud_of(tr, src, 0, 0)
    m = cfg.peract.model
    lang = torch.zeros((1, m.lang_max_seq_len, m.lang_emb_dim), device=dev)
    with deterministic_algorithms(torch), torch.inference_mode():
        server, _, _ = serve.build_server(serve_argv + ["--device", str(dev)])
        vox = voxelize(*cloud[:2], tr.bounds, cfg.peract.voxelizer, valid=cloud[2])
        trained = state.module["policy"].eval()
        got = server.net(vox, cloud[3], lang)
        want_out = trained(vox, cloud[3], lang)
    logits_equal = all(torch.equal(a, b) for a, b in zip(got[:3], want_out[:3]))
    del server, got, want_out, trained, state
    t = time.perf_counter()
    trace = serve.main(serve_argv + ["--device", str(dev)])
    serve_s = time.perf_counter() - t
    emit("checkpoint_serve", logits_equal_to_trained=logits_equal, act_steps=len(trace),
         actions=[{k: np.round(np.asarray(a[k], float), 4).tolist()
                   for k in ("xyz", "rotation", "gripper_open")} for a in trace],
         serve_s=serve_s, card=card)
    if not logits_equal or len(trace) != 2:
        fail("checkpoint: the served policy differs from the trained one")

    # ---- eval_quality over every variant, each kernel variant's frame
    # against its plain field's
    frames, launches = {}, {}
    # the checkpoint's policy with the forward kernels on (they refuse grad,
    # so training ran without them; the parameters are the same)
    knobs_on = ["-o", "peract.model.use_flash_attention=true",
                "-o", "peract.model.stats_backend=pallas"]
    zero()

    def on_frame(name, rend, frame):
        now = read()
        launches[name] = {k: now[k] for k in ("ray_expand", "corner_lerp",
                                              "fused_resnetfc_int8",
                                              "fused_gather_resnetfc_int8")}
        launches[name]["policy"] = {k: now[k] for k in ("flash_attention", "spatial_stats_3d",
                                                        "conv3d_k3")}
        frames[name] = frame
        zero()

    seam = eval_quality.on_frame
    eval_quality.on_frame = on_frame
    t = time.perf_counter()
    try:
        with deterministic_algorithms(torch):
            report = eval_quality.main(knobs_on + [
                "--config", cfg_path, "--ckpt-dir", ckpt, "--data-root", kitchen,
                "--n-demos", str(CKPT_DEMOS), "--holdout-demos", str(CKPT_DEMOS - 1),
                "--n-perturb", "1", "--out", os.path.join(tmp, "quality.json"),
                "--device", str(dev)])
    finally:
        eval_quality.on_frame = seam
    eval_s = time.perf_counter() - t
    decode_launches = read()   # the BC decodes, after the last frame
    with deterministic_algorithms(torch), torch.inference_mode():
        vox = voxelize(*cloud[:2], tr.bounds, cfg.peract.voxelizer, valid=cloud[2])
        d0 = tr._policy_out(tr_state, cloud, lang)[3]
    pose = torch.as_tensor(src.gt_pose, device=dev)[None]
    focal = torch.tensor(src.focal, device=dev)
    checks = {}
    for name, overrides in eval_quality.VARIANTS:
        if "mlp_backend" not in overrides:
            continue
        rend = NeuralRenderer(eval_quality.variant_config(
            cfg.renderer, dict(overrides, mlp_backend="xla")), device=dev)
        rend.load_field(tr_state.module["nerf"].state_dict())
        with deterministic_algorithms(torch), torch.inference_mode():
            occ = rend.prepare(d0[:1], occupancy=vox[0, ..., -1],
                               generator=torch.Generator(device=dev).manual_seed(0))
            plan = (rend.plan_rays(occ, pose, focal) if rend.cfg.use_ray_plan
                    and rend.cfg.sampling_mode == "occupancy" and occ is not None else None)
            rgb_x = rend.render_image(d0[:1], pose, focal,
                                      torch.Generator(device=dev).manual_seed(7),
                                      occ=occ, plan=plan)[0].float()
        rgb = torch.as_tensor(frames[name], device=dev)
        gap, db = (rgb - rgb_x).abs().max().item(), psnr(rgb, rgb_x).item()
        n_kernels = sum(v for k, v in launches[name].items() if k != "policy")
        checks[name] = dict(max_rgb_gap=gap, psnr_db=db, launches=launches[name],
                            ok=gap <= RGB_TOL and db >= PSNR_MIN and n_kernels > 0)
    names = [k for k, _ in eval_quality.VARIANTS if k in report]
    emit("checkpoint_eval", variants=names, eval_s=eval_s,
         psnr={k: report[k]["psnr"] for k in names},
         psnr_holdout={k: report[k].get("psnr_holdout") for k in names},
         note=f"a field trained for {CKPT_STEPS} steps from random weights is not a learned "
              "field: these PSNRs are no quality figures and are compared with nothing",
         bc=report["bc"], bc_holdout=report.get("bc_holdout_demo"),
         bc_se3_perturbed=report.get("bc_se3_perturbed"),
         kernel_vs_plain_field=checks, rgb_tol=RGB_TOL, psnr_min=PSNR_MIN,
         decode_launches={k: decode_launches[k] for k in ("flash_attention",
                                                           "spatial_stats_3d", "conv3d_k3")},
         launches_xla_variants={k: launches[k] for k in launches if k not in checks},
         card=card)
    bad = [k for k, c in checks.items() if not c["ok"]]
    if bad:
        fail(f"checkpoint: kernel variants off their plain field's frame: {bad}")
    if not all(decode_launches[k] for k in ("flash_attention", "spatial_stats_3d", "conv3d_k3")):
        fail(f"checkpoint: the decodes launched {decode_launches}")
    del tr_state, d0, frames

    t = time.perf_counter()
    lines = analyze_bc.main(knobs_on + ["--config", cfg_path, "--ckpt-dir", ckpt, "--data-root",
                                        kitchen, "--n-demos", str(CKPT_DEMOS),
                                        "--device", str(dev)])
    analyze_s = time.perf_counter() - t
    t = time.perf_counter()
    res = extract_nerf_feat.main(["--config", cfg_path, "--ckpt-dir", ckpt,
                                  "--out", os.path.join(tmp, "feat.npz"), "--device", str(dev)])
    extract_s = time.perf_counter() - t
    grid_sample.FUSED_LERP_BACKEND = "xla"
    n_pts = int(res["points"].shape[0])
    emit("checkpoint_tools", analyze_bc_lines=len(lines), analyze_s=analyze_s,
         extract_points=n_pts, extract_threshold=float(res["threshold"]),
         extract_s=extract_s, card=card)
    if len(lines) != CKPT_DEMOS * (CKPT_KEYFRAMES - 1) or not n_pts:
        fail(f"checkpoint: analyze_bc wrote {len(lines)} lines, extract_nerf_feat "
             f"{n_pts} points")
    tmp_dir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    emit("checkpoint", phase_wall_s=time.perf_counter() - t_phase, card=card)


def sac_on_live_pixels(torch, np, dev):
    """A few SAC updates on 64 x 64 pixels from a live MuJoCo env (lift,
    one front camera): SAC_LIVE["transitions"] random transitions into a
    buffer, then SAC_LIVE["updates"] updates of a batch from it on `dev`."""
    from real_robot_nerf_actor_tpu_torch.envs import make_env
    from real_robot_nerf_actor_tpu_torch.rl import ReplayBuffer, SACAgent, SACConfig

    env = make_env(task_name="lift", obs_mode="image", image_size=SAC_LIVE["hw"],
                   episode_length=50, seed=0)
    env.action_space.seed(0)
    obs, _ = env.reset(seed=0)
    agent = SACAgent(SACConfig(action_dim=4, obs_type="image"), obs, device=dev)
    rb = ReplayBuffer(SAC_LIVE["transitions"], obs.shape, 4)
    t0 = time.perf_counter()
    for i in range(SAC_LIVE["transitions"]):
        a = env.action_space.sample()
        nobs, r, term, trunc, _ = env.step(a)
        rb.add(obs, a, r, nobs, term)
        obs = env.reset(seed=i + 1)[0] if term or trunc else nobs
    env_s = time.perf_counter() - t0
    times, losses = [], []
    for _ in range(SAC_LIVE["updates"]):
        t = time.perf_counter()
        m = agent.update(rb.sample(SAC_LIVE["batch"]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(m["critic_loss"])
    if not all(map(math.isfinite, losses)):
        fail(f"envs_fixture: SAC on live pixels, non-finite critic loss {losses}")
    return dict(sac_env_s=env_s, sac_update_ms=times, sac_critic_losses=losses,
                sac_obs_shape=list(obs.shape), sac_batch=SAC_LIVE["batch"])


def envs_forensics_phase(torch, np, dev, card):
    """Phase 15: the MuJoCo xArm suite's data on the card, and the gradient
    forensics tool at full width.

    a. The fixture tools/gen_data.py wrote with the port's envs
       (FIXTURE_DIR: 3 lift point-cloud episodes, 2 orbit scenes; its
       manifest lists the command, each file's digest and the cuts), its
       digests checked. Where mujoco and gymnasium import, the fixture is
       written again from the manifest's commands (every digest equal) and
       SAC takes a few updates on pixels from a live env; else the line
       says "mujoco": "absent". Then:
         - envs_episodes: the episodes through EpisodeDataset into
           PerActTrainer of configs/peract.yaml with conv_backend "pallas".
           The first step (fp32, the fixture's first keyframe pair, the
           same weights and draws, deterministic algorithms): on the card
           the kernel path (conv3d_k3 and its VJP) against the plain conv,
           each gradient within GRAD_TOL of its scale plus ULP_K times the
           plain path's own error against the card's float64 step, a
           conv3d_k3 VJP scaled by 1.01 failing it; the CPU's fp32 step
           beside them, each side's error against float64 reported (on
           these sparse clouds a few entries of the card's fp32 gradients,
           on either conv path, sit far off float64 where the CPU's do not,
           so phase 10 f's fp32 card-vs-CPU rule does not hold); card
           against CPU in float64 at F64_VOXELS, every gradient within
           F64_TOL of its scale, input_preprocess.Conv_0.bias named, and a
           fault confined to that bias failing it. Then EPISODE_STEPS bf16
           steps from EpisodeDataset.batches with conv3d_k3 and its VJP
           launched once each a step;
         - envs_scenes: the scenes, the seed-drawn ViT-S/8 teacher's
           features dumped into them, into the FeatureNeRF step of
           configs/featurenerf.yaml as written (its 0.5-1.8 m band is these
           orbits'): the first step held to the CPU's by phase 9's rule
           (featurenerf_first_step_check, its two planted faults).
    b. forensics: a multi-kitchen dataset (FORENSICS_DATA) and
       configs/nerfact.yaml in setting b (conv3d_k3 and corner_lerp with
       their VJPs) trained FORENSICS_STEPS steps through train/nerfact.main
       --multi-root --ckpt-dir, every step logged, a checkpoint at
       FORENSICS_MID; tools/grad_forensics.py replay from that checkpoint
       must give the run's logged metrics bit for bit (both on
       deterministic algorithms). Two faults, each planted in a copy of the
       checkpoint: a field weight set to inf (FIELD_FAULT: replay stashes
       the first --max-stash steps of every step's event and no others;
       dissect finds loss_render non-finite and the BC terms finite, and
       each term's own graph leaves only loss_render's gradients
       non-finite, the planted weight among them) and a latent
       self-attention weight set to inf (ATTN_FAULT: probe's first row is
       that block's, mint names its segment first). Step ms of replay and
       dissect with the launches of conv3d_k3 and corner_lerp (and their
       VJPs), counters zeroed before each tool and read after; one replayed
       step under the profiler.
    The phase states its seconds. Fails on a digest that differs, a first
    step off its reference, a planted fault that passes, a replay off the run,
    a fault not located, or launches other than one conv3d_k3 (and VJP)
    and two corner_lerp (and VJPs) a step."""
    import glob
    import importlib.util
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
    from real_robot_nerf_actor_tpu_torch.data.episodes import EpisodeDataset, load_trajectory
    from real_robot_nerf_actor_tpu_torch.data.kitchen import write_multi_kitchen_dataset
    from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import load_scene
    from real_robot_nerf_actor_tpu_torch.ops import conv3d_cuda, grid_sample
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.tools import eval_quality, gen_data, grad_forensics
    from real_robot_nerf_actor_tpu_torch.train import nerfact
    from real_robot_nerf_actor_tpu_torch.train.distill2d import dump_teacher_features
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import (
        FeatureNerfConfig, FeatureNerfTrainer)
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict, to_dict

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    fixture = Path(__file__).resolve().parent / FIXTURE_DIR
    manifest = json.loads((fixture / "manifest.json").read_text())
    digests = {n: gen_data.npz_digest(str(fixture / n)) for n in sorted(manifest["sha256"])}
    live = {}
    present = all(importlib.util.find_spec(m) is not None for m in ("mujoco", "gymnasium"))
    if present:
        regen = os.path.join(tmp, "regen")
        for cmd in manifest["commands"]:
            gen_data.main([*cmd, "--out", regen])
        live["regenerated"] = {n: gen_data.npz_digest(os.path.join(regen, n))
                               for n in sorted(os.listdir(regen))}
        live.update(sac_on_live_pixels(torch, np, dev))
    emit("envs_fixture", mujoco="present" if present else "absent", files=sorted(digests),
         bytes=sum(p.stat().st_size for p in fixture.iterdir()),
         digests_equal=digests == manifest["sha256"], cuts=manifest["cuts"], **live, card=card)
    if digests != manifest["sha256"]:
        fail(f"envs_fixture: digests {digests} against the manifest's {manifest['sha256']}")
    if present and live["regenerated"] != manifest["sha256"]:
        fail("envs_fixture: the regenerated fixture differs from the manifest")

    # ------------------------------------------- a: episodes -> PerAct step
    base = from_dict(PerActConfig, PERACT)
    trajs = [load_trajectory(str(p)) for p in sorted(fixture.glob("ep_*.npz"))]
    draws = torch.tensor(EPISODE_DRAWS)
    datasets = {}

    def config(v, dtype, backend):
        return dataclasses.replace(
            base, model=dataclasses.replace(base.model, voxel_size=v, compute_dtype=dtype,
                                            conv_backend=backend),
            voxelizer=dataclasses.replace(base.voxelizer, voxel_size=v))

    def dataset(v):
        if v not in datasets:
            datasets[v] = EpisodeDataset(trajs, base.coord_bounds, voxel_size=v,
                                         rotation_resolution=base.rotation_resolution,
                                         max_num_coords=base.voxelizer.max_num_coords)
        return datasets[v]

    def weights(v):
        return PerActTrainer(config(v, "float32", "pallas"), device="cpu").init_state(
            torch.Generator().manual_seed(0)).module.state_dict()

    vjp = conv3d_cuda.conv3d_k3_vjp

    def scaled_vjp(*args, **kw):
        return tuple(None if t is None else t * 1.01 for t in vjp(*args, **kw))

    def first_step(device, dtype, backend, v, sd, fault=None):
        """The first step's gradients (float64, on the host, in the plain
        conv's names) and loss from the weights `sd` on the fixture's first
        keyframe pair, on deterministic algorithms."""
        tr = PerActTrainer(config(v, dtype, backend), device=device)
        state = tr.init_state(torch.Generator().manual_seed(0))
        state.module.load_state_dict(sd if backend == "pallas" else final_conv_as_plain(sd))
        wide = dtype == "float64"
        if wide:
            state.module.double()
        batch = {k: torch.as_tensor(a[None], device=device) for k, a in dataset(v).get(0).items()}
        if wide:
            batch = {k: t.double() if t.is_floating_point() else t for k, t in batch.items()}
        if fault == "bias_scaled":
            state.module.input_preprocess.Conv_0.bias.register_hook(
                lambda g: g * (1.0 + BIAS_FAULT))
        if fault == "vjp_scaled":
            conv3d_cuda.conv3d_k3_vjp = scaled_vjp
        try:
            with deterministic_algorithms(torch):
                state, m = tr.train_step(state, batch,
                                         draws=draws.to(device, batch["points"].dtype))
        finally:
            conv3d_cuda.conv3d_k3_vjp = vjp
        grads = {n: q.grad.detach().double().cpu() for n, q in state.module.named_parameters()}
        return (final_conv_as_plain(grads) if backend == "pallas" else grads), m["loss"].item()

    def gaps(got, want, bound):
        """{tensor: largest |got - want| over bound(tensor)}, the invariant bias out."""
        return {n: ((got[n] - w).abs().max() / bound(n)).item() for n, w in want.items()
                if not n.endswith(INVARIANT)}

    def worst(d):
        n = max(d, key=d.get)
        return {"of_tol": d[n], "name": n}

    # the kernels against the plain conv at full size, on the card: each
    # gradient within GRAD_TOL of its scale plus ULP_K times the plain
    # path's own fp32 error against the float64 step
    v = base.model.voxel_size
    sd = weights(v)
    t0 = time.perf_counter()
    g64, loss64 = first_step(dev, "float64", "conv2d", v, sd)
    gk, loss_k = first_step(dev, "float32", "pallas", v, sd)
    gp, loss_p = first_step(dev, "float32", "conv2d", v, sd)
    gf, _ = first_step(dev, "float32", "pallas", v, sd, "vjp_scaled")

    def kernel_bound(n):
        return (GRAD_TOL * gp[n].abs().max() + ULP_K * (gp[n] - g64[n]).abs().max() + 1e-30)

    kernel = worst(gaps(gk, gp, kernel_bound))
    planted = worst(gaps(gf, gp, kernel_bound))
    card_s = time.perf_counter() - t0
    # the CPU's fp32 step beside them, against the same float64 step: on
    # these sparse clouds a few entries of the card's fp32 gradients (either
    # conv path) sit far off float64 where the CPU's do not, so phase 10 f's
    # card-vs-CPU rule in fp32 does not hold here; card and CPU are held in
    # float64 instead (below)
    t0 = time.perf_counter()
    g_cpu, loss_c = first_step(cpu, "float32", "pallas", v, sd)
    cpu32_s = time.perf_counter() - t0

    def of_scale(g):
        return worst(gaps(g, g64, lambda n: g64[n].abs().max() + 1e-300))

    fp32_errors = {"card_kernel": of_scale(gk), "card_plain": of_scale(gp), "cpu": of_scale(g_cpu),
                   "card_vs_cpu_of_grad_tol": worst(gaps(
                       gk, g_cpu, lambda n: GRAD_TOL * g_cpu[n].abs().max() + 1e-30))}
    n = fp32_errors["card_kernel"]["name"]    # the CPU's error on the card's worst tensor
    fp32_errors["cpu_on_that_tensor"] = ((g_cpu[n] - g64[n]).abs().max()
                                         / g64[n].abs().max()).item()
    # float64, card against CPU, at F64_VOXELS: every gradient (the input
    # conv's bias among them) within F64_TOL of its scale; a fault confined
    # to that bias must fail
    sd_small = weights(F64_VOXELS)
    t0 = time.perf_counter()
    want64, want_loss = first_step(cpu, "float64", "conv2d", F64_VOXELS, sd_small)
    cpu64_s = time.perf_counter() - t0
    got64, got_loss = first_step(dev, "float64", "conv2d", F64_VOXELS, sd_small)
    bad64, _ = first_step(dev, "float64", "conv2d", F64_VOXELS, sd_small, "bias_scaled")

    def f64_bound(n):
        return F64_TOL * want64[n].abs().max() + 1e-300

    f64 = gaps(got64, want64, f64_bound)
    f64_fault = gaps(bad64, want64, f64_bound)
    bias = "input_preprocess.Conv_0.bias"
    float64 = {"voxel_size": F64_VOXELS, "worst": worst(f64), "input_conv_bias": f64[bias],
               "loss_gap": abs(got_loss - want_loss) / (F64_TOL * abs(want_loss)),
               "planted_bias_scaled": {"input_conv_bias": f64_fault[bias],
                                       "worst": worst(f64_fault)}, "cpu_reference_s": cpu64_s}
    # the bf16 kernel step through EpisodeDataset.batches, counters zeroed first
    tr = PerActTrainer(config(v, base.model.compute_dtype, "pallas"), device=dev)
    state = tr.init_state(torch.Generator().manual_seed(0))
    batches = dataset(v).batches(batch_size=1, seed=0, device=dev)
    losses, times = [], []
    conv3d_k3.launches = conv3d_k3.wgmma_launches = conv3d_k3.vjp_calls = 0
    for _ in range(EPISODE_STEPS):
        t = time.perf_counter()
        _, m = tr.train_step(state, next(batches), draws=draws.to(dev))
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t) * 1e3)
    launches = {"conv3d_k3": conv3d_k3.launches, "conv3d_k3_wgmma": conv3d_k3.wgmma_launches,
                "conv3d_k3_vjp": conv3d_k3.vjp_calls}
    emit("envs_episodes", episodes=len(trajs), keyframe_pairs=len(dataset(v)),
         points_per_cloud=int(trajs[0].observations[0]["points"].shape[0]),
         compute_dtype=base.model.compute_dtype, conv_backend="pallas", steps=EPISODE_STEPS,
         step_ms=times, losses=losses, launches=launches,
         kernel_vs_plain=kernel, planted_vjp_scaled=planted,
         losses_first_step={"float64": loss64, "kernel": loss_k, "plain": loss_p, "cpu": loss_c},
         fp32_errors_of_float64_scale=fp32_errors, float64=float64, f64_tol=F64_TOL,
         card_check_s=card_s, cpu_fp32_s=cpu32_s, card=card)
    want = dict.fromkeys(launches, EPISODE_STEPS)
    if launches != want:
        fail(f"envs_episodes: launches {launches} over {EPISODE_STEPS} steps, want {want}")
    if not all(map(math.isfinite, losses)):
        fail(f"envs_episodes: non-finite loss {losses}")
    if not kernel["of_tol"] <= 1.0 or not planted["of_tol"] > 1.0:
        fail(f"envs_episodes: kernels against the plain conv {kernel}, planted {planted}")
    if not (float64["worst"]["of_tol"] <= 1.0 and float64["loss_gap"] <= 1.0):
        fail(f"envs_episodes: float64 card against CPU {float64}")
    if not f64_fault[bias] > 1.0:
        fail(f"envs_episodes: the float64 check does not see the planted bias fault {f64_fault}")
    del tr, state

    # --------------------------------------- a: scenes -> FeatureNeRF step
    scenes = os.path.join(tmp, "scenes")
    os.makedirs(scenes)
    for p in sorted(fixture.glob("scene_*.npz")):
        shutil.copy(p, scenes)
    t0 = time.perf_counter()
    dump_teacher_features(scenes, device=dev, **FNERF_TEACHER)
    dump_s = time.perf_counter() - t0
    sc = load_scene(sorted(glob.glob(os.path.join(scenes, "*.npz")))[0])
    fcfg = from_dict(FeatureNerfConfig, FEATURENERF)
    sd0 = FeatureNerfTrainer(fcfg, device="cpu").init_state(
        torch.Generator().manual_seed(0)).module.state_dict()
    res = featurenerf_first_step_check(torch, dev, fcfg, sc, sd0, FNERF_SRC3,
                                       line="envs_scenes")
    emit("envs_scenes", scenes=len(os.listdir(scenes)), views=int(sc.images.shape[0]),
         hw=list(sc.images.shape[1:3]), features=list(sc.features.shape),
         z_band=[fcfg.z_near, fcfg.z_far], dump_s=dump_s, **res, card=card)

    # ------------------------------------------------- b: grad_forensics
    data = os.path.join(tmp, "multi")
    t0 = time.perf_counter()
    write_multi_kitchen_dataset(data, device=dev, **FORENSICS_DATA)
    write_s = time.perf_counter() - t0
    ncfg = setting_b()
    ncfg = dataclasses.replace(ncfg, peract=dataclasses.replace(ncfg.peract, train=dataclasses.replace(
        ncfg.peract.train, num_steps=FORENSICS_STEPS, ckpt_every=FORENSICS_MID, log_every=1,
        eval_every=10 ** 9)))
    cfg_path = os.path.join(tmp, "nerfact_b.json")
    with open(cfg_path, "w") as f:
        json.dump(to_dict(ncfg), f)
    ckpt, log = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
    tool = ["--config", cfg_path, "--multi-root", data, "--device", str(dev)]
    counters = {"conv3d_k3": (conv3d_k3, "wgmma_launches"),
                "conv3d_k3_vjp": (conv3d_k3, "vjp_calls"),
                "corner_lerp": (corner_lerp, "cuda_launches"),
                "corner_lerp_vjp": (corner_lerp, "vjp_calls")}
    per_step = {"conv3d_k3": 1, "conv3d_k3_vjp": 1, "corner_lerp": 2, "corner_lerp_vjp": 2}

    def zero():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    step_ms = []
    train_step = nerfact.NerfActTrainer.train_step

    def timed_step(self, *args, **kw):
        t = time.perf_counter()
        out = train_step(self, *args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def plant(name, fault):
        """A copy of the midway checkpoint with `fault` (name, index) set to inf."""
        d = os.path.join(tmp, f"ckpt_{name}")
        os.makedirs(d)
        ck = torch.load(os.path.join(ckpt, f"ckpt_{FORENSICS_MID}.pt"), weights_only=True)
        ck["params"][fault[0]][fault[1]] = float("inf")
        torch.save(ck, os.path.join(d, f"ckpt_{FORENSICS_MID}.pt"))
        return d

    lerp_backend = grid_sample.FUSED_LERP_BACKEND
    grid_sample.FUSED_LERP_BACKEND = "pallas"
    nerfact.NerfActTrainer.train_step = timed_step
    try:
        with deterministic_algorithms(torch) as nondeterministic_ops:
            zero()
            t0 = time.perf_counter()
            nerfact.main(tool + ["--steps", str(FORENSICS_STEPS), "--ckpt-dir", ckpt,
                                 "--log-dir", log, "--no-resume"])
            train_s = time.perf_counter() - t0
            run_launches, run_ms = read(), step_ms[:]
            del step_ms[:]
            zero()
            t0 = time.perf_counter()
            rec = grad_forensics.main(tool + [
                "--mode", "replay", "--ckpt-dir", ckpt, "--from-step", str(FORENSICS_MID),
                "--replay-steps", str(FORENSICS_STEPS - FORENSICS_MID),
                "--out", os.path.join(tmp, "replay")])
            replay_s = time.perf_counter() - t0
            replay_launches, replay_ms = read(), step_ms[:]
            del step_ms[:]
            # one replayed step under the profiler: the kernels by name
            tr, state = eval_quality.restore_joint(ncfg, ckpt, dev)
            batch = next(tr.multi_replay_data(load_multitask_entries(data), 1))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                train_step(tr, state, batch, torch.Generator().manual_seed(0))
                torch.cuda.synchronize()
            profiled = kernel_counts(prof)
            del tr, state, batch, prof
            # fault 1: a field weight
            rec1 = grad_forensics.main(tool + [
                "--mode", "replay", "--ckpt-dir", plant("field", FIELD_FAULT), "--replay-steps",
                str(FORENSICS_STEPS - FORENSICS_MID), "--max-stash", "2",
                "--out", os.path.join(tmp, "field")])
            del step_ms[:]
            zero()
            t0 = time.perf_counter()
            dis = grad_forensics.main(tool + ["--mode", "dissect", "--stash", rec1["stashes"][0]])
            dissect_s = time.perf_counter() - t0
            dissect_launches = read()
            # fault 2: a latent self-attention weight
            rec2 = grad_forensics.main(tool + [
                "--mode", "replay", "--ckpt-dir", plant("attention", ATTN_FAULT),
                "--replay-steps", "1", "--max-stash", "1", "--out", os.path.join(tmp, "attn")])
            t0 = time.perf_counter()
            rows = grad_forensics.main(tool + ["--mode", "probe", "--stash", rec2["stashes"][0]])
            probe_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            minted = grad_forensics.main(tool + ["--mode", "mint", "--stash",
                                                 rec2["stashes"][0]])
            mint_s = time.perf_counter() - t0
    finally:
        nerfact.NerfActTrainer.train_step = train_step
        grid_sample.FUSED_LERP_BACKEND = lerp_backend

    logged = {}
    with open(os.path.join(log, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["category"] == "train":
                logged[r["step"]] = r
    diffs = {m["step"]: sorted(k for k in m if k != "step" and m[k] != logged[m["step"]].get(k))
             for m in rec["metrics"]}
    replayed = FORENSICS_STEPS - FORENSICS_MID
    emit("forensics", data=FORENSICS_DATA, steps=FORENSICS_STEPS, checkpoint=FORENSICS_MID,
         write_s=write_s, train_s=train_s, run_step_ms=run_ms, run_launches=run_launches,
         replay_s=replay_s, replay_step_ms=replay_ms[1:], draw_record_step_ms=replay_ms[0],
         replay_launches=replay_launches, replay_steps_run=replayed + 1,
         replay_losses=[m["loss_total"] for m in rec["metrics"]],
         run_losses=[logged[m["step"]]["loss_total"] for m in rec["metrics"]],
         replay_diff_keys=diffs, profiled_replay_step=profiled,
         nondeterministic_ops=nondeterministic_ops, card=card)
    if any(diffs.values()) or len(rec["metrics"]) != replayed:
        fail(f"forensics: the replay is not the run: {diffs}")
    for name, got, n in (("run", run_launches, FORENSICS_STEPS),
                         ("replay", replay_launches, replayed + 1)):
        want = {k: v * n for k, v in per_step.items()}
        if got != want:
            fail(f"forensics: {name} launches {got}, want {want}")
    if profiled["conv3d_k3"] != 1 or profiled["corner_lerp"] != 2:
        fail(f"forensics: the profiled step's kernels {profiled}")

    terms = dis["terms"]
    alone = {t: [r[0] for r in rows_] for t, rows_ in dis["nonfinite_alone"].items()}
    emit("forensics_field_fault", fault=list(FIELD_FAULT), events=rec1["events"],
         stashes=[os.path.basename(p) for p in rec1["stashes"]], terms=terms,
         probes=dis["probes"], nonfinite_leaves={t: len(r) for t, r in dis["nonfinite"].items()},
         nonfinite_alone={t: len(r) for t, r in alone.items()},
         dissect_s=dissect_s, dissect_launches=dissect_launches, card=card)
    want_events = list(range(FORENSICS_MID, FORENSICS_STEPS))
    if rec1["events"] != want_events or [os.path.basename(p) for p in rec1["stashes"]] != [
            f"stash_step{s}.npz" for s in want_events[:2]]:
        fail(f"forensics: field fault events {rec1['events']} stashes {rec1['stashes']}")
    bc = ("loss_trans", "loss_rot_grip", "loss_trans_aux")
    if math.isfinite(terms["loss_render"]) or not all(math.isfinite(terms[t]) for t in bc):
        fail(f"forensics: field fault terms {terms}")
    if set(alone) != {"loss_render"} or FIELD_FAULT[0] not in alone["loss_render"]:
        fail(f"forensics: the terms' own graphs' non-finite leaves {alone}")

    block = ATTN_FAULT[0].split(".")[1]
    emit("forensics_attention_fault", fault=list(ATTN_FAULT), events=rec2["events"],
         probe_first=rows[:3], probe_nonfinite=sum(r["bad"] > 0 for r in rows),
         probe_rows=len(rows), probe_s=probe_s, mint=minted["rows"],
         mint_first_nonfinite=minted["first_nonfinite"], mint_s=mint_s, card=card)
    if not (rec2["events"] == [FORENSICS_MID] and rows[0]["bad"] > 0
            and rows[0]["name"].startswith(block)):
        fail(f"forensics: probe's first row {rows[0]}, want {block}'s")
    if minted["first_nonfinite"] != f"{block}(x)":
        fail(f"forensics: mint named {minted['first_nonfinite']}, want {block}(x)")
    tmp_dir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    emit("envs_forensics", seconds=time.perf_counter() - t_phase, card=card)


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

    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
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
    # of its own.
    l2_evict = torch.zeros(2 ** 27, dtype=torch.float32, device=dev)   # 512 MB

    def flush():   # a read, so that the L2 is left holding clean lines
        l2_evict.sum()

    for v, c, dtype in [(100, 64, torch.float32), (20, 128, torch.float32),
                        (100, 64, torch.bfloat16)]:
        dname = str(dtype).split(".")[1]
        errs, errs_of_den = {}, {}
        for scale in (0.3, 0.01):
            feat = randn(1, v, v, v, c, dtype=dtype, scale=scale)
            cuda_launches = spatial_stats_3d.cuda_launches
            got = spatial_stats_3d(feat)
            want = spatial_stats_3d_plain(feat)
            torch.cuda.synchronize()
            if spatial_stats_3d.cuda_launches != cuda_launches + 1:
                fail(f"spatial_stats_3d {v}^3x{c}: did not launch csrc/spatial_stats.cu")
            den = want[..., :1]
            errs[scale] = (got - want).abs().max().item()
            errs_of_den[scale] = ((got - want).abs() / den).max().item()
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
        plain_ms = median_ms(torch, lambda: spatial_stats_3d_plain(feat), 5)
        dev_ms = profiled_ms(torch, lambda: spatial_stats_3d(feat), 20)
        # the same with the L2 evicted before each call (the volume is
        # written by the layer before it on the act step; these calls
        # would otherwise find part of it in L2)
        cold_ms = profiled_ms(torch, lambda: spatial_stats_3d(feat), 20, flush)
        # ~10 fp32 operations an element (sub, mul, exp, 4 adds, 3 muls)
        b_ms, b_by = bound(10.0 * feat.numel(), feat.numel() * feat.element_size()
                           + got.numel() * 4, "float32")
        emit("kernel", name="spatial_stats_3d", shape=[1, v, v, v, c], dtype=dname,
             design="bulk ring" if pl.bulk else "plain loads", slabs=pl.slabs,
             rows_per_slab=pl.rows_per_slab, stage_rows=pl.stage_rows,
             calls_per_step=1, input_scales=list(errs), max_abs_err=max(errs.values()),
             max_err_of_den=list(errs_of_den.values()), tol_of_den=STATS_TOL,
             tail_dropped_err_of_den=tail_err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
             cold_l2_device_ms=cold_ms, library_ms=None, bound_ms=b_ms,
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
    sd_off = final_conv_as_plain(sd_on)
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
        rows = device_rows(torch, prof)
        device_ms = sum(r[1] for r in rows)
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

    # ------------------------------------------------------------ 6. train
    train_phase(torch, dev, card)

    # ---------------------------------------------------------- 7. nerfact
    nerfact_phase(torch, dev, card)

    # ----------------------------------------------------------- 8. replay
    replay_phase(torch, dev, card)

    # ------------------------------------------------------ 9. featurenerf
    fnerf_state, fnerf_views = featurenerf_phase(torch, np, dev, card)

    # --------------------------------------------------------------- 10. bc
    bc_phase(torch, np, dev, card, fnerf_state, fnerf_views)
    del fnerf_state

    # ---------------------------------------------------------- 11. teacher
    teacher_phase(torch, np, dev, card)

    # ----------------------------------------------------------- 12. camera
    camera_phase(torch, np, dev, card, server_on, server_off)

    # --------------------------------------------------------- 13. parallel
    lang_t = server_on.lang
    del server_on, server_off, out_on, out_off
    gc.collect()
    torch.cuda.empty_cache()
    parallel_phase(torch, np, dev, card, (cfg_on, sd_on), vox, proprio, lang_t)

    # ------------------------------------------------------- 14. checkpoint
    checkpoint_phase(torch, np, dev, card)

    # --------------------------------------------------- 15. envs_forensics
    envs_forensics_phase(torch, np, dev, card)

    # ------------------------------------------------------ summary
    info = {
        "flash_attention": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/flash_attention.cu",
                            "real_robot_nerf_actor_tpu/ops/attention_pallas.py:70"),
        "conv3d_k3": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/conv3d_k3.cu",
                      "real_robot_nerf_actor_tpu/ops/conv3d_pallas.py:46"),
        "spatial_stats_3d": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/spatial_stats.cu",
                             "real_robot_nerf_actor_tpu/ops/stats_pallas.py:59"),
        "corner_lerp": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/corner_lerp.cu",
                        "real_robot_nerf_actor_tpu/ops/lerp_pallas.py:59"),
        "ray_expand": ("cuda", "real_robot_nerf_actor_tpu_torch/csrc/ray_expand.cu",
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
