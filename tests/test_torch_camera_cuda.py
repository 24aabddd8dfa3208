"""The camera act path and the one-scatter grid backward on a CUDA card.
Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_camera_cuda.py

Without a card every test skips. The camera path: 480 x 640 frames of the
synthetic scene through the host filters, then `CameraActor.step` on the
card with the kernel knobs on (flash attention, the k3 conv, the spatial
stats: 3 / 1 / 3 launches a step at depth 1) against the knobs off on the
same weights and frames: the same world points (1e-6 of their scale), the
logits within 1e-4 of their scale (fp32, as the policy test). The grid
backward: `grid_sample_3d_fastbwd` against autograd through
`grid_sample_3d` on the card, fp32 within 1e-5 of the gradient's scale
(`index_add_`'s atomics add in another order), bf16 within 2^-5 (autograd
takes the lerp weights in bf16, each up to 2^-9 off, and rounds every
corner's product and sum to bf16; the fast path weighs in fp32 and rounds
once); the forward equal bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    REALSENSE_INTRINSICS, camera_extrinsic, camera_frames, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig, PerceiverIO
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec, voxelize
from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
from real_robot_nerf_actor_tpu_torch.ops.grid_sample import grid_sample_3d, grid_sample_3d_fastbwd
from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
from real_robot_nerf_actor_tpu_torch.ops.voxelize import pad_points
from real_robot_nerf_actor_tpu_torch.train.serve import (
    CameraActor, PolicyServer, ServeConfig, camera_points)

pytestmark = pytest.mark.cuda

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_camera_act_step_kernels_match_plain(cuda):
    on = PerceiverConfig(depth=1, voxel_size=20, num_latents=64, latent_dim=64,
                         im_channels=16, latent_heads=2, final_dim=16, lang_emb_dim=32,
                         lang_max_seq_len=8, input_encoder="unet", use_flash_attention=True,
                         conv_backend="pallas", stats_backend="pallas")
    off = dataclasses.replace(on, use_flash_attention=False, conv_backend="xla",
                              stats_backend="xla")
    sd = PerceiverIO.initialized(on, torch.Generator().manual_seed(0)).state_dict()
    sd_off = dict(sd)
    sd_off["final.Conv_0.weight"] = sd_off.pop("final.pallas_kernel").permute(4, 3, 0, 1, 2)
    sd_off["final.Conv_0.bias"] = sd_off.pop("final.pallas_bias")
    lang = np.random.default_rng(4).standard_normal((8, 32)).astype(np.float32)
    spec = VoxelizerSpec(voxel_size=20, feature_size=3, max_num_coords=220000)
    actors = [CameraActor(PolicyServer(ServeConfig(coord_bounds=BOUNDS), cfg, spec, s, lang,
                                       device=cuda), REALSENSE_INTRINSICS, camera_extrinsic())
              for cfg, s in ((on, sd), (off, sd_off))]
    scene = make_synthetic_scene(seed=0, n_points=2000000)
    depth, rgb = camera_frames(scene, REALSENSE_INTRINSICS, camera_extrinsic(), n_frames=2)
    for f in depth:
        filtered = actors[0].filters(f)
        np.testing.assert_array_equal(filtered, actors[1].filters(f))
        pts = [a.points(filtered, rgb)[0] for a in actors]
        torch.testing.assert_close(pts[0], pts[1], rtol=0, atol=0)
        cpu = camera_points(filtered, rgb, REALSENSE_INTRINSICS,
                            torch.as_tensor(camera_extrinsic()), torch.tensor(BOUNDS))[0]
        scale = cpu.abs().max().item()
        torch.testing.assert_close(pts[0].cpu(), cpu, rtol=0, atol=1e-6 * scale)
        counts = (flash_attention.launches, conv3d_k3.launches, spatial_stats_3d.launches)
        packed = actors[0].step(filtered, rgb, np.zeros(3), np.zeros(3), 1.0)
        torch.cuda.synchronize()
        assert (flash_attention.launches - counts[0], conv3d_k3.launches - counts[1],
                spatial_stats_3d.launches - counts[2]) == (3, 1, 3)
        assert torch.isfinite(packed).all() and actors[0].last_num_points > 100000
        # the logits of both paths on the same grid
        p, c = actors[0].points(filtered, rgb)
        p, c, valid = pad_points(p[None], c[None], spec.max_num_coords)
        srv = [a.server for a in actors]
        with torch.inference_mode():
            vox = voxelize(p, c, srv[0].bounds, spec, valid=valid)
            proprio = torch.tensor([[3.0, 4.0, 5.0, 30.0, 2.0, 40.0, 1.0]], device=cuda)
            got = srv[0].net(vox, proprio, srv[0].lang)
            want = srv[1].net(vox, proprio, srv[1].lang)
        for g, w in zip(got, want):
            scale = max(1.0, w.abs().max().item())
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -5)])
def test_grid_sample_fastbwd_matches_autograd(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    grid = torch.randn((1, 40, 40, 40, 64), generator=g, device=cuda).to(dtype)
    coords = torch.rand((1, 8192, 3), generator=g, device=cuda) * 2.2 - 1.1
    cot = torch.randn((1, 8192, 64), generator=g, device=cuda).to(dtype)
    fast = grid.clone().requires_grad_()
    auto = grid.clone().requires_grad_()
    out_f = grid_sample_3d_fastbwd(fast, coords)
    out_a = grid_sample_3d(auto, coords)
    assert torch.equal(out_f, out_a)
    out_f.backward(cot)
    out_a.backward(cot)
    scale = auto.grad.float().abs().max().item()
    torch.testing.assert_close(fast.grad.float(), auto.grad.float(), rtol=0, atol=tol * scale)
