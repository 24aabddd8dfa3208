"""On the card: the profiler names of the six port kernels are the names the
roofline and device-time metrics read, so that a kernel renamed fails here
instead of leaving a metric silent. Skips without a card (the decision is
made in the `card` fixture).

    python -m pytest h100_bench/tests -m cuda     # on the H100
"""
from __future__ import annotations

import pytest
import torch

from h100_bench.core.kernels import KERNEL_NAMES
from h100_bench.core.scenes import orbit_poses


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CPU}


@pytest.mark.cuda
def test_the_six_kernels_carry_the_names_the_metrics_read(card):
    from real_robot_nerf_actor_tpu_torch.models.nerf_field import NerfFieldConfig
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
    from real_robot_nerf_actor_tpu_torch.render.renderer import NeuralRenderer, RendererConfig

    g = torch.Generator(device=card).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    field = NerfFieldConfig(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                            int8_static_act=True, mask_outside=True)
    rend = NeuralRenderer(RendererConfig(image_width=64, image_height=64, n_coarse=16,
                                         n_fine=8, n_fine_depth=0, sampling_mode="occupancy",
                                         use_ray_plan=True, occ_source="field", field=field),
                          device=card).init_params(torch.Generator(device=card).manual_seed(0))
    sd = {k: v.clone() for k, v in rend.field.state_dict().items()}
    sd["mlp_coarse.lin_out_bias"][3] = 1.0      # a field that is not empty
    rend.load_field(sd)
    d0 = randn(1, 20, 20, 20, 64, dtype=torch.float32)
    pose = torch.as_tensor(orbit_poses(1), device=card)

    def run():
        flash_attention(randn(1, 1, 128, 64), randn(1, 1, 192, 64), randn(1, 1, 192, 64))
        conv3d_k3(randn(1, 20, 20, 20, 128), randn(3, 3, 3, 128, 64),
                  randn(64, dtype=torch.float32))
        spatial_stats_3d(randn(1, 20, 20, 20, 64, dtype=torch.float32))
        corner_lerp(randn(4096, 8 * 64), randn(8, 4096, dtype=torch.float32))
        occ = rend.prepare(d0, generator=torch.Generator(device=card).manual_seed(1))
        rend.calibrate_int8_act(d0, rend.frame_rays(pose, 60.0),
                                generator=torch.Generator(device=card).manual_seed(2))
        rend.render_image(d0, pose, 60.0, generator=torch.Generator(device=card).manual_seed(3),
                          occ=occ, plan=rend.plan_rays(occ, pose, 60.0))

    run()
    names = _profiled_names(run)
    for kernel, needles in KERNEL_NAMES.items():
        assert any(n in name for n in needles for name in names), (kernel, sorted(names)[:40])
