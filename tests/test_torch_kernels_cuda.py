"""The port's Hopper kernels against their plain PyTorch versions on a CUDA
card. Imports neither JAX nor the JAX package, so it runs on a machine with
a card and no JAX:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Without a card every test skips. Tolerances: attention fp32 1e-4 absolute
(outputs below 2), bf16 2^-6 of the largest |output|, i.e. two bf16 ulps of
it (one ulp where the two roundings of the output land apart, plus the
probabilities rounded to bf16 at other points of the online softmax); with
standard-normal inputs the outputs shrink as Nk grows (std ~ sqrt(e / Nk),
about 0.02 at 8077 keys), so the tolerance scales with them. Conv 2^-7 of
the output scale in bf16 (one rounding plus the bias placement), 1e-4 of
it in fp32; stats 1e-5 of each channel's denominator (fp32 sums of up to
10^6 terms in another order, the exp of a fast-math instruction), on
inputs of scale 0.3 (a few rows dominate) and 0.01 (every row counts).
"""
import dataclasses

import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig, PerceiverIO
from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import (
    flash_attention, flash_attention_plain)
from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import (
    conv3d_k3, conv3d_k3_plain)
from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import (
    spatial_stats_3d, spatial_stats_3d_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,nq,nk", [(1, 2048, 8077), (8, 2048, 2048),
                                         (1, 8077, 2048), (2, 77, 125)])
def test_flash_attention(cuda, dtype, heads, nq, nk):
    q, k, v = (_randn((1, heads, n, 64), s).to(cuda, dtype)
               for s, n in ((0, nq), (1, nk), (2, nk)))
    launches = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v).float()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


def test_flash_attention_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 1, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [((2, 7, 11, 6), 12, 10),
                                            ((1, 13, 11, 9), 40, 24),
                                            ((1, 100, 100, 100), 128, 64)])
def test_conv3d_k3(cuda, dtype, shape, cin, cout):
    x = _randn(shape + (cin,), 0).to(cuda, dtype)
    w = _randn((3, 3, 3, cin, cout), 1, 0.05).to(cuda, dtype)
    b = _randn((cout,), 2).to(cuda)
    launches = conv3d_k3.launches
    got = conv3d_k3(x, w, b)
    torch.cuda.synchronize()
    assert conv3d_k3.launches == launches + 1
    want = conv3d_k3_plain(x, w, b).float()
    scale = want.abs().max().item()
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2 ** -7 * scale
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("shape,dtype", [((1, 100, 100, 100, 64), torch.float32),
                                         ((1, 20, 20, 20, 128), torch.float32),
                                         ((1, 100, 100, 100, 64), torch.bfloat16),
                                         ((2, 8, 8, 8, 6), torch.float32)])
def test_spatial_stats_3d(cuda, shape, dtype):
    x = _randn(shape, 0, 0.3).to(cuda, dtype)
    launches = spatial_stats_3d.launches
    got = spatial_stats_3d(x)
    torch.cuda.synchronize()
    assert spatial_stats_3d.launches == launches + 1
    want = spatial_stats_3d_plain(x)
    # error relative to each channel's denominator, which bounds the
    # numerators (|lin| <= 1)
    assert ((got - want).abs() / want[..., :1]).max().item() <= 1e-5


def test_conv3d_k3_refuses_a_weight_in_another_dtype(cuda):
    x = torch.zeros((1, 4, 4, 4, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="cast the weight once"):
        conv3d_k3(x, torch.zeros((3, 3, 3, 8, 4), device=cuda))


@pytest.mark.parametrize("shape,dtype", [((1, 100, 100, 100, 64), torch.float32),
                                         ((1, 20, 20, 20, 128), torch.float32),
                                         ((1, 100, 100, 100, 64), torch.bfloat16)])
def test_spatial_stats_3d_every_row_counts(cuda, shape, dtype):
    """Input spread equal to the temperature, so every row adds to every
    sum, the 576 rows of the last partial slab of 100^3 included: dropping
    that slab would miss the tolerance by far."""
    x = _randn(shape, 5, 0.01).to(cuda, dtype)
    got = spatial_stats_3d(x)
    want = spatial_stats_3d_plain(x)
    den = want[..., :1]
    assert ((got - want).abs() / den).max().item() <= 1e-5
    n_rows = shape[1] ** 3
    tail = n_rows % 2048 or 2048
    cut = x.reshape(shape[0], n_rows, shape[4]).clone()
    cut[:, n_rows - tail:] = float("-inf")     # exp -> 0: those rows dropped
    dropped = spatial_stats_3d_plain(cut.reshape(shape))
    assert ((dropped - want).abs() / den).max().item() > 10 * 1e-5


def test_policy_kernel_path_matches_plain_path(cuda):
    """A small PerceiverIO in fp32: the three knobs on (kernels) against off
    (plain versions), same weights; 1e-4 of the logit scale."""
    on = PerceiverConfig(depth=1, voxel_size=20, num_latents=64, latent_dim=64,
                         im_channels=16, latent_heads=2, final_dim=16,
                         lang_emb_dim=32, lang_max_seq_len=8,
                         input_encoder="unet", use_flash_attention=True,
                         conv_backend="pallas", stats_backend="pallas")
    off = dataclasses.replace(on, use_flash_attention=False,
                              conv_backend="xla", stats_backend="xla")
    net_on = PerceiverIO.initialized(on, torch.Generator().manual_seed(0))
    sd = net_on.state_dict()
    sd["final.Conv_0.weight"] = sd.pop("final.pallas_kernel").permute(4, 3, 0, 1, 2)
    sd["final.Conv_0.bias"] = sd.pop("final.pallas_bias")
    net_off = PerceiverIO(off)
    net_off.load_state_dict(sd)
    net_on.to(cuda)
    net_off.to(cuda)
    vox = _randn((1, 20, 20, 20, 10), 3).to(cuda)
    proprio = torch.tensor([[3.0, 4.0, 5.0, 30.0, 2.0, 40.0, 1.0]], device=cuda)
    lang = _randn((1, 8, 32), 4).to(cuda)
    counts = (flash_attention.launches, conv3d_k3.launches, spatial_stats_3d.launches)
    with torch.no_grad():
        got = net_on(vox, proprio, lang)
        want = net_off(vox, proprio, lang)
    torch.cuda.synchronize()
    assert (flash_attention.launches - counts[0], conv3d_k3.launches - counts[1],
            spatial_stats_3d.launches - counts[2]) == (3, 1, 3)
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
