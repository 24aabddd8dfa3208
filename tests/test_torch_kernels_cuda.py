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
from real_robot_nerf_actor_tpu_torch.ops import attention_cuda
from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import (
    flash_attention, flash_attention_plain, flash_attention_split_plain, plan_splits)
from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import (
    conv3d_k3, conv3d_k3_plain)
from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import (
    plan, spatial_stats_3d, spatial_stats_3d_plain)

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
    """bf16 reaches the wgmma kernel (split by plan_splits: 8, 1, 2 and 1
    here), fp32 the SIMT kernel; both against the plain version."""
    q, k, v = (_randn((1, heads, n, 64), s).to(cuda, dtype)
               for s, n in ((0, nq), (1, nk), (2, nk)))
    launches, wgmma = flash_attention.launches, flash_attention.wgmma_launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert flash_attention.wgmma_launches == wgmma + (dtype == torch.bfloat16)
    if dtype == torch.bfloat16:
        assert flash_attention.last_plan["splits"] == plan_splits(heads, nq, nk)
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v).float()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("heads,nq,nk,splits", [(1, 2048, 8077, 1), (1, 2048, 8077, 3),
                                                (1, 2048, 8077, 16), (2, 77, 125, 2),
                                                (1, 8077, 2048, 5), (8, 2048, 2048, 2)])
def test_flash_attention_split_kv(cuda, monkeypatch, heads, nq, nk, splits):
    """Forced split counts (the planner patched), ragged last chunks
    included: each chunk's (m, l, acc) in scratch and the combine kernel,
    against the plain version and the plain split algebra."""
    monkeypatch.setattr(attention_cuda, "plan_splits", lambda *a: splits)
    q, k, v = (_randn((1, heads, n, 64), s).to(cuda, torch.bfloat16)
               for s, n in ((3, nq), (4, nk), (5, nk)))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.last_plan["splits"] == min(splits, -(-nk // 64))
    want = flash_attention_plain(q, k, v).float()
    tol = 2 ** -6 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    split = flash_attention_split_plain(q, k, v, splits).float()
    torch.testing.assert_close(got.float(), split, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,nq,nk", [(1, 2048, 8077), (8, 2048, 2048), (2, 77, 125)])
def test_flash_attention_strided_views(cuda, dtype, heads, nq, nk):
    """MHAttention's layout: q, k, v as split-heads views of (B, N, H*64)
    projections (k and v two halves of one), the output written through a
    view of a (B, Nq, H*64) tensor."""
    inner = heads * 64
    qp = _randn((2, nq, inner), 6).to(cuda, dtype)
    kv = _randn((2, nk, 2 * inner), 7).to(cuda, dtype)
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, 64).transpose(1, 2)  # noqa: E731
    q, k, v = split(qp), split(kv[..., :inner]), split(kv[..., inner:])
    out = torch.full((2, nq, inner), float("nan"), device=cuda, dtype=dtype)
    got = flash_attention(q, k, v, out=split(out))
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    want = flash_attention_plain(q, k, v).float()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * want.abs().max().item()
    torch.testing.assert_close(split(out).float(), want, rtol=0, atol=tol)


def test_flash_attention_masks_padded_keys(cuda, monkeypatch):
    """Every real score is about -24 (k = -3 (u + noise) against q near u),
    so the 51 keys that TMA reads as zeros past Nk = 8077 would score 0 and
    swamp them. The kernel masks them: it passes where the plain version
    with those zero keys appended fails by far."""
    rng = np.random.default_rng(7)
    u = np.ones(64, np.float32)
    q = u + 0.1 * rng.standard_normal((1, 1, 2048, 64)).astype(np.float32)
    k = -3.0 * (u + 0.1 * rng.standard_normal((1, 1, 8077, 64)).astype(np.float32))
    v = rng.standard_normal((1, 1, 8077, 64)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (q, k, v))
    assert ((q.float() @ k.float().transpose(-1, -2)) * 0.125).max().item() <= -20
    want = flash_attention_plain(q, k, v).float()
    tol = 2 ** -6 * want.abs().max().item()
    got = flash_attention(q, k, v).float()            # 8 splits
    monkeypatch.setattr(attention_cuda, "plan_splits", lambda *a: 1)
    got_one = flash_attention(q, k, v).float()        # one pass
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(got_one, want, rtol=0, atol=tol)
    pad = torch.zeros((1, 1, 51, 64), device=cuda, dtype=torch.bfloat16)
    faulty = flash_attention_plain(q, torch.cat([k, pad], 2), torch.cat([v, pad], 2))
    assert (faulty.float() - want).abs().max().item() > 10 * tol


def test_flash_attention_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 1, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [((2, 7, 11, 6), 12, 10),
                                            ((1, 13, 11, 9), 40, 24),
                                            ((1, 100, 100, 100), 128, 64),
                                            ((1, 13, 11, 9), 64, 24),
                                            ((2, 7, 11, 6), 128, 200),
                                            ((1, 5, 9, 17), 192, 8)])
def test_conv3d_k3(cuda, dtype, shape, cin, cout):
    """bf16 with Cin % 64 == 0 and Cout % 8 == 0 reaches the wgmma kernel
    (bricks of 16 x 8 x 2 voxels, none of these volumes a multiple of it in
    every axis); the rest the first kernel."""
    x = _randn(shape + (cin,), 0).to(cuda, dtype)
    w = _randn((3, 3, 3, cin, cout), 1, 0.05).to(cuda, dtype)
    b = _randn((cout,), 2).to(cuda)
    launches, wgmma = conv3d_k3.launches, conv3d_k3.wgmma_launches
    got = conv3d_k3(x, w, b)
    torch.cuda.synchronize()
    assert conv3d_k3.launches == launches + 1
    routed = dtype == torch.bfloat16 and cin % 64 == 0 and cout % 8 == 0
    assert conv3d_k3.wgmma_launches == wgmma + routed
    want = conv3d_k3_plain(x, w, b).float()
    scale = want.abs().max().item()
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2 ** -7 * scale
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("shape,dtype", [((1, 100, 100, 100, 64), torch.float32),
                                         ((1, 20, 20, 20, 128), torch.float32),
                                         ((1, 100, 100, 100, 64), torch.bfloat16),
                                         ((2, 8, 8, 8, 6), torch.float32),
                                         ((1, 12, 12, 12, 5), torch.bfloat16),
                                         ((3, 16, 16, 16, 12), torch.bfloat16),
                                         ((1, 10, 10, 10, 3000), torch.float32)])
def test_spatial_stats_3d(cuda, shape, dtype):
    """The act step's three volumes (bulk-copy ring), odd channel counts and
    a batch of three (plain loads, bf16 rows of 24 bytes), more channels
    than one block takes (plain loads in groups of 512)."""
    x = _randn(shape, 0, 0.3).to(cuda, dtype)
    launches = spatial_stats_3d.launches
    got = spatial_stats_3d(x)
    torch.cuda.synchronize()
    assert spatial_stats_3d.launches == launches + 1
    assert spatial_stats_3d.last_plan == plan(shape, x.element_size(), x.data_ptr(),
                                              torch.cuda.get_device_properties(cuda)
                                              .multi_processor_count)
    want = spatial_stats_3d_plain(x)
    # error relative to each channel's denominator, which bounds the
    # numerators (|lin| <= 1)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ((got - want).abs() / want[..., :1]).max().item() <= 1e-5
    # the same bits on a second call: the fold runs in a fixed order
    assert torch.equal(spatial_stats_3d(x), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_stats_3d_edge_slabs(cuda, dtype):
    """At d0's shape: channel 0 of slab 1 lies 40 below the rest (its fold
    factor underflows to 0), channel 1 of the last slab and channel 2 of
    slab 0's first stage are -inf throughout; a result with no NaN within
    the tolerance of the plain version."""
    shape = (1, 100, 100, 100, 64)
    x = _randn(shape, 6, 0.3).to(cuda, dtype)
    pl = plan(shape, x.element_size(), x.data_ptr(),
              torch.cuda.get_device_properties(cuda).multi_processor_count)
    flat = x.view(1, -1, 64)
    flat[:, pl.rows_per_slab:2 * pl.rows_per_slab, 0] -= 40.0
    flat[:, (pl.slabs - 1) * pl.rows_per_slab:, 1] = float("-inf")
    flat[:, :pl.stage_rows, 2] = float("-inf")
    got = spatial_stats_3d(x)
    want = spatial_stats_3d_plain(x)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() / want[..., :1]).max().item() <= 1e-5


def test_conv3d_k3_wgmma_without_bias(cuda):
    x = _randn((1, 9, 8, 16, 64), 3).to(cuda, torch.bfloat16)
    w = _randn((3, 3, 3, 64, 64), 4, 0.05).to(cuda, torch.bfloat16)
    wgmma = conv3d_k3.wgmma_launches
    got = conv3d_k3(x, w)
    torch.cuda.synchronize()
    assert conv3d_k3.wgmma_launches == wgmma + 1
    want = conv3d_k3_plain(x, w).float()
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=2 ** -7 * want.abs().max().item())


def test_conv3d_k3_refuses_a_weight_in_another_dtype(cuda):
    x = torch.zeros((1, 4, 4, 4, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="cast the weight once"):
        conv3d_k3(x, torch.zeros((3, 3, 3, 8, 4), device=cuda))


@pytest.mark.parametrize("shape,dtype", [((1, 100, 100, 100, 64), torch.float32),
                                         ((1, 20, 20, 20, 128), torch.float32),
                                         ((1, 100, 100, 100, 64), torch.bfloat16)])
def test_spatial_stats_3d_every_row_counts(cuda, shape, dtype):
    """Input spread equal to the temperature, so every row adds to every
    sum, the rows of the kernel's last, shorter slab included: dropping
    that slab would miss the tolerance by far."""
    x = _randn(shape, 5, 0.01).to(cuda, dtype)
    got = spatial_stats_3d(x)
    want = spatial_stats_3d_plain(x)
    den = want[..., :1]
    assert ((got - want).abs() / den).max().item() <= 1e-5
    n_rows = shape[1] ** 3
    pl = spatial_stats_3d.last_plan
    tail = n_rows - (pl.slabs - 1) * pl.rows_per_slab      # the kernel's last slab
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


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [((1, 13, 11, 9), 64, 24),
                                            ((2, 7, 11, 6), 12, 10)])
def test_conv3d_k3_gradients(cuda, monkeypatch, dtype, shape, cin, cout):
    """The kernel's Function against the plain path on one output gradient:
    bit for bit against its own backward code (conv3d_k3_vjp), and within
    one rounding of the gradient against autograd of conv3d_k3_plain (fp32
    1e-4, bf16 2^-7 of each gradient's scale)."""
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3_vjp
    # the same weight gradient twice
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    x = _randn(shape + (cin,), 0).to(cuda, dtype).requires_grad_()
    w = _randn((3, 3, 3, cin, cout), 1, 0.05).to(cuda, dtype).requires_grad_()
    b = _randn((cout,), 2).to(cuda).requires_grad_()
    g = _randn(shape + (cout,), 3).to(cuda, dtype)
    launches = conv3d_k3.launches
    conv3d_k3(x, w, b).backward(g)
    assert conv3d_k3.launches == launches + 1
    got = (x.grad, w.grad, b.grad)
    with torch.no_grad():
        same = conv3d_k3_vjp(x, w, g)
    for a, c in zip(got, same):
        assert torch.equal(a, c)
    assert x.grad.is_contiguous()     # NDHWC from cuDNN, not a strided view
    xp, wp, bp = (t.detach().clone().requires_grad_() for t in (x, w, b))
    conv3d_k3_plain(xp, wp, bp).backward(g)
    for a, c in zip(got, (xp.grad, wp.grad, bp.grad)):
        assert a.dtype == c.dtype and a.shape == c.shape
        scale = c.float().abs().max().item()
        tol = (1e-4 if dtype == torch.float32 or c.dtype == torch.float32 else 2 ** -7) * scale
        torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("m", [65536, 1000])
def test_corner_lerp_gradients(cuda, m):
    """The kernel's Function against autograd of corner_lerp_plain: d_rows
    within one bf16 ulp of each value, d_w (fp32 sums over 64 channels in
    another order) within 1e-5 of its scale."""
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp, corner_lerp_plain
    rows = _randn((m, 512), 0).to(cuda, torch.bfloat16).requires_grad_()
    w = torch.rand((8, m), generator=torch.Generator().manual_seed(1)).to(cuda)
    w.requires_grad_()
    g = _randn((m, 64), 2).to(cuda, torch.bfloat16)
    launches = corner_lerp.launches
    corner_lerp(rows, w).backward(g)
    assert corner_lerp.launches == launches + 1
    rp, wp = rows.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    corner_lerp_plain(rp, wp).backward(g)
    d, dp = rows.grad.float(), rp.grad.float()
    assert ((d - dp).abs() <= 2 ** -7 * dp.abs() + 1e-30).all()
    torch.testing.assert_close(w.grad, wp.grad, rtol=0, atol=1e-5 * wp.grad.abs().max().item())


def test_kernels_without_backward_raise_under_grad(cuda):
    """flash_attention, spatial_stats_3d, ray_expand and the two int8 MLP
    entry points refuse an input that requires a gradient under grad mode,
    and run under no_grad."""
    from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    q = _randn((1, 1, 128, 64), 0).to(cuda, torch.bfloat16).requires_grad_()
    vol = _randn((1, 8, 8, 8, 16), 1).to(cuda).requires_grad_()
    rays, z, exp = _serve_inputs(cuda, 256, 4, dims=(6, 7, 9))
    z.requires_grad_()
    sd = {k: v.to(cuda) for k, v in _random_mlp_state().items()}
    packed = rf.pack_resnetfc_params(sd)
    zi = rf.pack_mlp_input(_randn((64, 64), 2).to(cuda), torch.zeros((64, 3), device=cuda),
                           torch.zeros((64, 3), device=cuda), 6, 1.5).requires_grad_()
    rows_all = exp.reshape(-1, 512).requires_grad_()
    flat = torch.zeros(64, dtype=torch.int32, device=cuda)
    w8 = torch.full((8, 64), 0.125, device=cuda)
    aux = torch.zeros((24, 64), dtype=torch.bfloat16, device=cuda)
    calls = {
        "flash_attention": lambda: flash_attention(q, q, q),
        "spatial_stats_3d": lambda: spatial_stats_3d(vol),
        "ray_expand": lambda: ray_expand(rays, z, (6, 7, 9), BOUNDS),
        "fused_resnetfc_int8": lambda: rf.fused_resnetfc_int8(zi, packed),
        "fused_gather_resnetfc_int8": lambda: rf.fused_gather_resnetfc_int8(
            rows_all, flat, w8, aux, packed),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def _grad_policy(**knobs):
    return PerceiverConfig(depth=1, voxel_size=20, num_latents=64, latent_dim=64,
                           im_channels=16, latent_heads=2, final_dim=16,
                           lang_emb_dim=32, lang_max_seq_len=8, input_encoder="unet",
                           conv_backend="pallas", **knobs)


def test_policy_backward_through_the_conv_kernel(cuda, monkeypatch):
    """conv_backend="pallas" in training: backward() gives `final`'s
    pallas_kernel and pallas_bias the plain path's gradients (the same net
    with the plain conv); with use_flash_attention or stats_backend="pallas"
    on, backward is refused."""
    from real_robot_nerf_actor_tpu_torch.models import blocks
    net = PerceiverIO.initialized(_grad_policy(), torch.Generator().manual_seed(0)).to(cuda)
    vox = _randn((1, 20, 20, 20, 10), 3).to(cuda)
    proprio = torch.tensor([[3.0, 4.0, 5.0, 30.0, 2.0, 40.0, 1.0]], device=cuda)
    lang = _randn((1, 8, 32), 4).to(cuda)
    weights = None

    def grads():
        nonlocal weights
        net.zero_grad()
        outs = [o.float() for o in net(vox, proprio, lang)]
        if weights is None:
            weights = [_randn(tuple(o.shape), 10 + i).to(cuda) for i, o in enumerate(outs)]
        sum((o * r).sum() for o, r in zip(outs, weights)).backward()
        return {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}

    launches = conv3d_k3.launches
    got = grads()
    assert conv3d_k3.launches == launches + 1
    monkeypatch.setattr(blocks, "conv3d_k3", conv3d_k3_plain)
    want = grads()
    assert set(got) == set(want)
    for k in ("final.pallas_kernel", "final.pallas_bias"):
        assert got[k].abs().max().item() > 0
    for k in want:
        scale = want[k].abs().max().item()
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-4 * max(scale, 1e-30))
    monkeypatch.undo()
    for knobs, name in (({"use_flash_attention": True}, "flash_attention"),
                        ({"stats_backend": "pallas"}, "spatial_stats_3d")):
        net = PerceiverIO.initialized(_grad_policy(**knobs),
                                      torch.Generator().manual_seed(0)).to(cuda)
        with pytest.raises(RuntimeError, match=name):
            net(vox, proprio, lang)


def test_conv3d_k3_function_finite_differences(cuda):
    """Conv3dK3's backward against central differences of the kernel's own
    forward, fp32, along random directions of x, the weight and the bias
    (gradcheck's test, one direction at a time). The conv is bilinear, so
    the central difference has no truncation error: what is left is fp32
    rounding of the sums, held to 1e-4 relative."""
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import Conv3dK3
    x = _randn((1, 5, 6, 7, 16), 0).to(cuda)
    w = _randn((3, 3, 3, 16, 8), 1, 0.1).to(cuda)
    b = _randn((8,), 2).to(cuda)
    r = _randn((1, 5, 6, 7, 8), 3).to(cuda)
    args = [t.clone().requires_grad_() for t in (x, w, b)]
    (Conv3dK3.apply(*args) * r).sum().backward()

    def f(*a):
        with torch.no_grad():
            return (Conv3dK3.apply(*a).double() * r.double()).sum().item()

    for i, t in enumerate((x, w, b)):
        for seed in (10, 11):
            d = _randn(tuple(t.shape), seed + 10 * i).to(cuda)
            eps = 0.5
            plus = [a.detach() + (eps * d if j == i else 0) for j, a in enumerate(args)]
            minus = [a.detach() - (eps * d if j == i else 0) for j, a in enumerate(args)]
            numeric = (f(*plus) - f(*minus)) / (2 * eps)
            analytic = (args[i].grad.double() * d.double()).sum().item()
            assert abs(numeric - analytic) <= 1e-4 * max(abs(analytic), 1.0), (i, numeric,
                                                                               analytic)


def test_tiny_train_step_kernel_matches_plain(cuda):
    """The port's PerAct train step at the tiny test size (depth 1, V 10,
    32 x 64 latents, 2000 points), fp32, from the same weights, batch and
    SE(3) draws: conv_backend "pallas" (the k3 kernel forward and its VJP)
    against "conv2d" (cuDNN). Each launches as it should; the loss metrics
    agree to 1e-5 relative and every gradient to 1e-4 of its tensor's
    largest |g| (the trans decoder's bias, whose gradient is zero, to
    1e-5 of the largest gradient of all)."""
    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
    model = dict(depth=1, voxel_size=10, num_latents=32, latent_dim=64, im_channels=8,
                 cross_dim_head=16, latent_dim_head=16, latent_heads=2, final_dim=8,
                 lang_emb_dim=16, lang_max_seq_len=4)
    runs = {}
    for conv in ("pallas", "conv2d"):
        cfg = PerActConfig(model=PerceiverConfig(**model, conv_backend=conv),
                           voxelizer=VoxelizerSpec(voxel_size=10, max_num_coords=2000))
        tr = PerActTrainer(cfg, device=cuda)
        state = tr.init_state(torch.Generator().manual_seed(0))
        if conv == "conv2d":
            state.module.load_state_dict(final_conv_as_plain(runs["pallas"]["sd"]))
        sd0 = {k: v.clone() for k, v in state.module.state_dict().items()}
        batch = next(tr.synthetic_data(batch_size=2, seed=1))
        launches = conv3d_k3.launches
        state, metrics = tr.train_step(state, batch, draws=torch.tensor(
            [[0.3, -0.7, 0.1], [-0.2, 0.9, -0.5]], device=cuda))
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in state.module.named_parameters()}
        if conv == "conv2d":
            grads["final.pallas_kernel"] = grads.pop("final.Conv_0.weight").permute(2, 3, 4, 1, 0)
            grads["final.pallas_bias"] = grads.pop("final.Conv_0.bias")
        runs[conv] = dict(sd=sd0, launches=conv3d_k3.launches - launches, grads=grads,
                          m={k: v.item() for k, v in metrics.items()})
    assert (runs["pallas"]["launches"], runs["conv2d"]["launches"]) == (1, 0)
    got, want = runs["pallas"], runs["conv2d"]
    for k, w in want["m"].items():
        assert abs(got["m"][k] - w) <= 1e-5 * abs(w), k
    top = max(g.abs().max().item() for g in want["grads"].values())
    assert got["grads"]["final.pallas_kernel"].abs().max() > 0
    for n, w in want["grads"].items():
        if n == "trans_decoder.bias":
            assert max(w.abs().max().item(), got["grads"][n].abs().max().item()) <= 1e-5 * top
            continue
        torch.testing.assert_close(got["grads"][n], w, rtol=0,
                                   atol=1e-4 * w.abs().max().item(), msg=lambda m: f"{n}: {m}")


def test_tiny_joint_step_kernels_match_plain(cuda, monkeypatch):
    """The port's NeRF-Actor joint step at the tiny size of
    tests/test_torch_train_nerfact.py (UNet encoder, 8 x 8 view, 64 rays of
    16 + 4 samples on the corner-expanded grid), fp32, from the same
    weights, batch and draws: the kernels (conv_backend "pallas" and
    corner_lerp) against their plain versions ("conv2d" and
    corner_lerp_plain on the same route). The kernel run launches the conv and its VJP once, the lerp and
    its VJP twice, the plain run neither; the metrics agree to 1e-5
    relative and every gradient to 1e-4 of its tensor's largest |g|. The
    UNet's head is scaled to 0.05, as in the CPU test: at full scale the
    spatial softmax at T = 0.01 amplifies fp32 rounding past that bound."""
    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.ops import grid_sample, lerp_cuda
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp, corner_lerp_plain
    from real_robot_nerf_actor_tpu_torch.render import RendererConfig
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    model = dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
                 cross_dim_head=8, latent_dim_head=8, latent_heads=2, final_dim=8,
                 lang_emb_dim=16, lang_max_seq_len=4, input_encoder="unet",
                 return_voxel_feat=True)
    render = RendererConfig(image_width=8, image_height=8, n_coarse=16, n_fine=4,
                            n_fine_depth=2, ray_chunk_size=64, fused_gather=True,
                            field=NerfFieldConfig(d_latent=8, d_embed=4, d_hidden=16,
                                                  n_blocks=2, combine_layer=1))
    g = torch.Generator().manual_seed(3)
    draws = dict(draws=torch.tensor([[0.3, -0.7, 0.1], [-0.2, 0.9, -0.5]], device=cuda),
                 ray_idx=torch.randint(0, 64, (64,), generator=g),
                 render_draws={"coarse_u": torch.rand((64, 16), generator=g),
                               "fine_u": torch.rand((64, 2), generator=g),
                               "fine_jitter": torch.rand((64, 2), generator=g),
                               "fine_depth_eps": torch.randn((64, 2), generator=g)})
    runs = {}
    monkeypatch.setattr(grid_sample, "FUSED_LERP_BACKEND", "pallas")
    for conv, lerp in (("pallas", corner_lerp), ("conv2d", corner_lerp_plain)):
        monkeypatch.setattr(lerp_cuda, "corner_lerp", lerp)
        cfg = NerfActConfig(peract=PerActConfig(
            model=PerceiverConfig(**model, conv_backend=conv),
            voxelizer=VoxelizerSpec(voxel_size=10, max_num_coords=512)), renderer=render)
        tr = NerfActTrainer(cfg, device=cuda)
        state = tr.init_state(torch.Generator().manual_seed(0))
        if conv == "conv2d":
            state.module.load_state_dict(final_conv_as_plain(runs["pallas"]["sd"], "policy."))
        else:
            with torch.no_grad():
                state.module["policy"].encoder_3d.Conv_0.weight.mul_(0.05)
        sd0 = {k: v.clone() for k, v in state.module.state_dict().items()}
        batch = next(tr.synthetic_data(batch_size=2, seed=1))
        counts = (conv3d_k3.launches, conv3d_k3.vjp_calls, corner_lerp.launches,
                  corner_lerp.vjp_calls)
        state, metrics = tr.train_step(state, batch, **draws)
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in state.module.named_parameters()}
        if conv == "conv2d":
            grads["policy.final.pallas_kernel"] = grads.pop(
                "policy.final.Conv_0.weight").permute(2, 3, 4, 1, 0)
            grads["policy.final.pallas_bias"] = grads.pop("policy.final.Conv_0.bias")
        runs[conv] = dict(sd=sd0, grads=grads, m={k: v.item() for k, v in metrics.items()},
                          launches=tuple(b - a for a, b in zip(counts, (
                              conv3d_k3.launches, conv3d_k3.vjp_calls,
                              corner_lerp.launches, corner_lerp.vjp_calls))))
    assert runs["pallas"]["launches"] == (1, 1, 2, 2)
    assert runs["conv2d"]["launches"] == (0, 0, 0, 0)
    got, want = runs["pallas"], runs["conv2d"]
    for k, w in want["m"].items():
        assert abs(got["m"][k] - w) <= 1e-5 * abs(w), k
    top = max(g.abs().max().item() for g in want["grads"].values())
    assert got["grads"]["policy.encoder_3d.Conv_0.weight"].abs().max() > 0
    for n, w in want["grads"].items():
        if n == "policy.trans_decoder.bias":
            assert max(w.abs().max().item(), got["grads"][n].abs().max().item()) <= 1e-5 * top
            continue
        torch.testing.assert_close(got["grads"][n], w, rtol=0,
                                   atol=1e-4 * w.abs().max().item(), msg=lambda m: f"{n}: {m}")


# ------------------------------------------------- serving renderer kernels
def _random_mlp_state(d_latent=64, d_hidden=512, n_blocks=5, combine=3, seed=0):
    """A ResnetFC state_dict with every weight random (std fan_in^-1/2)."""
    from real_robot_nerf_actor_tpu_torch.models import ResnetFC
    net = ResnetFC(d_in=42, d_out=4 + 32, n_blocks=n_blocks, d_latent=d_latent,
                   d_hidden=d_hidden, combine_layer=combine)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if v.dim() == 2:
            fan_in = v.shape[0] if k == "lin_out_kernel" else v.shape[1]
            sd[k] = torch.randn(v.shape, generator=g) * fan_in ** -0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    return sd


def _serve_inputs(cuda, r=4096, k=16, dims=(100, 100, 100), d_latent=64, seed=0,
                  grid_dtype=torch.bfloat16):
    from real_robot_nerf_actor_tpu_torch.ops.grid_sample import expand_corners
    rng = np.random.default_rng(seed)
    lo, hi = np.array(BOUNDS[:3]), np.array(BOUNDS[3:])
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (r, 3))
    d = rng.standard_normal((r, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.zeros((r, 2))], 1).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 0.6, (r, k)), axis=1).astype(np.float32)
    grid = _randn((1,) + tuple(dims) + (d_latent,), seed + 1).to(cuda, grid_dtype)
    return (torch.from_numpy(rays).to(cuda), torch.from_numpy(z).to(cuda),
            expand_corners(grid))


BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)


def _rays_leaving_every_face(r, k, seed=3):
    """Rays from inside the grid's box along +-x, +-y, +-z and at random,
    with samples out to twice the box's size, so that samples leave through
    every face; the last 8 rays reach z = 1e9, where the grid index lies
    outside the int32 range (the conversion saturates)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(BOUNDS[:3]), np.array(BOUNDS[3:])
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (r, 3))
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    d = rng.standard_normal((r, 3))
    d[:6 * (r // 12)] = np.repeat(axes, r // 12, axis=0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.zeros((r, 2))], 1).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)), axis=1)
    z[-8:] = np.linspace(1.0, 1e9, k)
    return torch.from_numpy(rays), torch.from_numpy(z.astype(np.float32))


@pytest.mark.parametrize("r,k,faces", [(4096, 16, False), (4096, 8, False), (4096, 24, False),
                                       (512, 16, False), (512, 8, False), (512, 24, False),
                                       (256, 3, False), (4096, 16, True), (512, 24, True)])
def test_ray_expand_equals_plain(cuda, r, k, faces):
    """Round-to-nearest intrinsics for every operation in the kernel:
    bit-equal to the torch elementwise ops, at the frame's tiles (K = 16,
    8), the calibration's 24 samples and a ragged K; `faces` takes samples
    out through every face of the grid."""
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import (
        ray_expand, ray_expand_plain)
    dims = (100, 100, 100) if r == 4096 else (6, 7, 9)
    if faces:
        rays, z = (t.to(cuda) for t in _rays_leaving_every_face(r, k))
    else:
        rays, z, _ = _serve_inputs(cuda, r, k, dims=(2, 2, 2))    # the grid is not used
    launches = ray_expand.launches
    got = ray_expand(rays, z, dims, BOUNDS)
    torch.cuda.synchronize()
    assert ray_expand.launches == launches + 1
    want = ray_expand_plain(rays, z, dims, BOUNDS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if faces:    # base indices clipped at both ends of every axis
        d, h, w = dims
        flat = want[2].long()
        for idx, size in ((flat % (w + 1), w), (flat // (w + 1) % (h + 1), h),
                          (flat // ((w + 1) * (h + 1)), d)):
            assert idx.min().item() == 0 and idx.max().item() == size


# (rows dtype, M, C, rows at an odd element offset, vector path expected)
_LERP_CASES = [(torch.bfloat16, 65536, 64, False, True), (torch.bfloat16, 1000, 64, False, True),
               (torch.float32, 32768, 64, False, True), (torch.float32, 1000, 8, False, True),
               (torch.bfloat16, 4096, 12, False, False), (torch.float32, 4096, 6, False, False),
               (torch.bfloat16, 4096, 64, True, False), (torch.float32, 999, 64, True, False)]


@pytest.mark.parametrize("case", range(len(_LERP_CASES)))
def test_corner_lerp(cuda, case):
    """Both paths of the kernel against the plain einsum: the 16-byte path
    (bf16 and fp32 rows), the scalar path for channels that are not whole
    16-byte chunks and for rows that start off a 16-byte boundary (a view
    into a flat buffer at an odd element offset, contiguous). bf16: one bf16
    ulp of each output, at most 2^-7 of it (the plain einsum sums in another
    order, and the two fp32 sums can round to neighbouring bf16 values).
    fp32: 1e-5 of the largest |output| (eight fp32 terms in another order,
    each under it); a dropped corner misses either by far."""
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import (
        corner_lerp, corner_lerp_plain, vector_path)
    dtype, m, c, odd, vector = _LERP_CASES[case]
    src = _randn((m * 8 * c + 1,), 0).to(cuda, dtype)
    rows = (src[1:] if odd else src[:-1]).view(m, 8 * c)
    w = torch.rand((8, m), generator=torch.Generator().manual_seed(1)).to(cuda)
    assert rows.is_contiguous() and vector_path(rows) == vector
    launches = corner_lerp.launches
    got = corner_lerp(rows, w)
    torch.cuda.synchronize()
    assert corner_lerp.launches == launches + 1
    assert got.dtype == dtype and got.shape == (m, c)
    want = corner_lerp_plain(rows, w).float()
    no_last = corner_lerp_plain(rows, w * torch.tensor([1.0] * 7 + [0.0], device=cuda)[:, None])
    for out, ok in ((got, True), (no_last, False)):
        gap = (out.float() - want).abs()
        if dtype == torch.bfloat16:
            within = (gap <= 2 ** -7 * want.abs() + 1e-6).all()
        else:
            within = (gap <= 1e-5 * want.abs().max()).all()
        assert bool(within) == ok


def _mlp_case(cuda, quantized, n, d_latent=64, d_hidden=512):
    from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf
    sd = {k: v.to(cuda) for k, v in _random_mlp_state(d_latent, d_hidden).items()}
    packed = rf.pack_resnetfc_params(sd, d_latent=d_latent, d_hidden=d_hidden,
                                     quantize=quantized)
    g = torch.Generator().manual_seed(2)
    latent = torch.randn((n, d_latent), generator=g).to(cuda)
    canon = torch.rand((n, 3), generator=g).to(cuda) * 1.2 - 0.1
    dirs = torch.randn((n, 3), generator=g).to(cuda)
    zi = rf.pack_mlp_input(latent, canon, dirs, 6, 1.5).contiguous()
    return rf, packed, zi


def _assert_mlp_close(got, want):
    """Largest gap within 2^-4 of each output's largest |value|, and at most
    1e-3 of the outputs more than one bf16 ulp (2^-8) of it apart: the
    kernel's fp32 sums run in another order than the plain version's, which
    can move a bf16 activation by one ulp, then an int8 code by one step,
    and the step cascades through the blocks in a few rows (the plain
    version moves by as much with its sums in float64; chip_smoke.py)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        scale = w.float().abs().max().item()
        gap = (g.float() - w.float()).abs()
        assert gap.max().item() <= 2 ** -4 * scale
        assert (gap > 2 ** -8 * scale).float().mean().item() <= 1e-3


@pytest.mark.parametrize("mode", ["dynamic", "static", "bf16"])
@pytest.mark.parametrize("n", [8192 + 37, 64])
def test_fused_resnetfc_int8(cuda, mode, n):
    quantized = mode != "bf16"
    rf, packed, zi = _mlp_case(cuda, quantized, n)
    scales = None
    if mode == "static":
        pb = rf.pack_resnetfc_params(
            {k: v for k, v in _random_mlp_state().items()}, quantize=False)
        amax = rf.capture_act_amax(zi.cpu(), pb)
        scales = [float(a) * 1.05 / 127 + 1e-8 for a in amax]
    launches, wgmma = rf.fused_resnetfc_int8.launches, rf.fused_resnetfc_int8.wgmma_launches
    got = rf.fused_resnetfc_int8(zi, packed, quantized=quantized, act_scales=scales)
    torch.cuda.synchronize()
    assert rf.fused_resnetfc_int8.launches == launches + 1
    assert rf.fused_resnetfc_int8.wgmma_launches == wgmma + quantized
    want = rf.fused_resnetfc_int8_plain(zi, packed, quantized=quantized,
                                        act_scales=scales)
    _assert_mlp_close(got, want)
    assert (got[0][:, 8:] == 0).all()
    # a kernel that skips the latent injection of block 2 misses the tolerance
    wrong = rf.fused_resnetfc_int8_plain(zi, packed, combine_layer=2,
                                         quantized=quantized, act_scales=scales)
    with pytest.raises(AssertionError):
        _assert_mlp_close(wrong, want)


@pytest.mark.parametrize("rows_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_gather_fused_equals_unfused_chain(cuda, mode, rows_dtype):
    """fused_gather_resnetfc_int8 == ray_expand -> gather -> corner_lerp ->
    fused_resnetfc_int8, bit for bit, at the render's coarse shape; both
    close to the plain gather mirror. The grid rows come in bf16 (the
    serving configs) and fp32 (a field with compute_dtype float32)."""
    from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    rays, z, exp = _serve_inputs(cuda, grid_dtype=rows_dtype)
    sd = {k: v.to(cuda) for k, v in _random_mlp_state().items()}
    packed = rf.pack_resnetfc_params(sd)
    aux, w8, flat = ray_expand(rays, z, (100, 100, 100), BOUNDS)
    n = flat.numel()
    aux, w8, flat = aux.reshape(-1, n), w8.reshape(8, n), flat.reshape(n)
    rows_all = exp.reshape(-1, 512)
    lat = corner_lerp(rows_all[flat.long()], w8).to(torch.bfloat16)
    zi = torch.cat([lat, aux.T, torch.zeros((n, 128 - 88), dtype=torch.bfloat16,
                                            device=cuda)], dim=-1)
    scales = None
    if mode == "static":     # calibrated on these rows, as the renderer does
        amax = rf.capture_act_amax(zi, rf.pack_resnetfc_params(sd, quantize=False))
        scales = [float(a) * 1.05 / 127 + 1e-8 for a in amax]
    want = rf.fused_resnetfc_int8(zi, packed, act_scales=scales)
    launches = rf.fused_gather_resnetfc_int8.launches
    wgmma = rf.fused_gather_resnetfc_int8.wgmma_launches
    got = rf.fused_gather_resnetfc_int8(rows_all, flat, w8, aux, packed, act_scales=scales)
    prev = rf.fused_gather_resnetfc_int8(rows_all, flat, w8, aux, packed, act_scales=scales,
                                         design="mma_sync")
    torch.cuda.synchronize()
    assert rf.fused_gather_resnetfc_int8.launches == launches + 2
    assert rf.fused_gather_resnetfc_int8.wgmma_launches == wgmma + 1
    for g, w, p in zip(got, want, prev):
        assert torch.equal(g, w)
        assert torch.equal(g, p)
    plain = rf.fused_gather_resnetfc_int8_plain(rows_all, flat, w8, aux, packed,
                                                act_scales=scales)
    _assert_mlp_close(got, plain)


def _static_scales(rf, zi, d_hidden=512):
    """Static scales calibrated on zi with the bf16 chain of the same
    weights, 5% headroom, as the renderer calibrates."""
    sd = {k: v.to(zi.device) for k, v in _random_mlp_state(d_hidden=d_hidden).items()}
    pb = rf.pack_resnetfc_params(sd, d_hidden=d_hidden, quantize=False)
    return [float(a) * 1.05 / 127 + 1e-8 for a in rf.capture_act_amax(zi, pb)]


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("n,d_hidden", [(64, 512), (8192 + 37, 512), (65536, 512),
                                        (8192 + 37, 256)])
def test_resnetfc_wgmma_equals_mma_sync(cuda, mode, n, d_hidden):
    """The wgmma design (the int8 main path) against the first kernel
    (design="mma_sync"): out and hidden equal bit for bit, since int32 sums
    are exact in any order and both run the same bf16 code and rounding
    points."""
    rf, packed, zi = _mlp_case(cuda, True, n, d_hidden=d_hidden)
    scales = _static_scales(rf, zi, d_hidden) if mode == "static" else None
    launches, wgmma = rf.fused_resnetfc_int8.launches, rf.fused_resnetfc_int8.wgmma_launches
    got = rf.fused_resnetfc_int8(zi, packed, act_scales=scales)
    prev = rf.fused_resnetfc_int8(zi, packed, act_scales=scales, design="mma_sync")
    torch.cuda.synchronize()
    assert rf.fused_resnetfc_int8.launches == launches + 2
    assert rf.fused_resnetfc_int8.wgmma_launches == wgmma + 1
    for g, p in zip(got, prev):
        assert g.shape == p.shape and torch.isfinite(g.float()).all()
        assert torch.equal(g, p)
    assert got[1].float().abs().max().item() > 0


def test_fused_resnetfc_refuses_wrong_weights(cuda):
    rf, packed, zi = _mlp_case(cuda, False, 64)
    with pytest.raises(TypeError, match="quantize"):
        rf.fused_resnetfc_int8(zi, packed, quantized=True)
    with pytest.raises(ValueError, match="wgmma design does not take"):
        rf.fused_resnetfc_int8(zi, packed, quantized=False, design="wgmma")


# conv3d_wgrad at the joint step's UNet shapes: (kind, Cin, Cout, k, stride,
# input side); S, L and the plain version as the backward hands them over.
# Then the other fp32 / float64 convs of the policy at configs/peract.yaml's
# widths, with their padding last: `final` (k3 on the edge-padded 102^3,
# 128 -> 64), up0's k5 on the edge-padded 24^3 and its k5 s5 transposed conv
_WGRAD_CASES = [("conv", 10, 8, 3, 1, 100), ("transposed", 16, 8, 3, 2, 50),
                ("conv", 8, 64, 1, 1, 100), ("conv", 64, 64, 3, 1, 13),
                ("conv", 16, 32, 3, 2, 50),
                ("conv", 128, 64, 3, 1, 102, 0), ("conv", 128, 64, 5, 1, 24, 0),
                ("transposed", 64, 64, 5, 5, 20)]


def _wgrad_operands(cuda, kind, cin, cout, k, stride, side, pad=None, seed=0,
                    dtype=torch.float32):
    if pad is None:
        pad = 1 if (kind == "conv" and k == 3) else 0
    out_side = (side + 2 * pad - k) // stride + 1 if kind == "conv" else (side - 1) * stride + k
    x = _randn((1, side, side, side, cin), seed).to(cuda, dtype)
    g = _randn((1, out_side, out_side, out_side, cout), seed + 1).to(cuda, dtype)
    s, l = (x, g) if kind == "transposed" else (g, x)
    return s, l, pad


@pytest.mark.parametrize("case", _WGRAD_CASES, ids=[f"{c[0]}-{c[1]}to{c[2]}-k{c[3]}s{c[4]}-{c[5]}"
                                                    + (f"p{c[6]}" if len(c) > 6 else "")
                                                    for c in _WGRAD_CASES])
def test_conv3d_wgrad(cuda, case):
    """The kernel against the plain version in float64, within 1e-12 of each
    element's sum of |products| (the two sum in other orders, in chains of
    up to 10^6 float64 additions whose roundings fall at random, about
    sqrt(n) x 1.1e-16 of that sum: 1.1e-13 at 10^6); fp32 against float64 on the
    same values within the fp32 chain's bound, (depth + 1) x 2^-24 of that
    sum, the depth being a thread's positions plus the groups and the
    partials it is summed with; two calls bit-equal; one count a call."""
    from real_robot_nerf_actor_tpu_torch.ops import conv3d_wgrad_cuda as cw
    kind, cin, cout, k, stride, side = case[:6]
    s, l, pad = _wgrad_operands(cuda, *case)
    s64, l64 = s.double(), l.double()
    abs_sum = cw.conv3d_wgrad_plain(s64.abs(), l64.abs(), k, stride, pad)
    want = cw.conv3d_wgrad_plain(s64, l64, k, stride, pad)
    before = cw.conv3d_wgrad.launches
    got64 = cw.conv3d_wgrad(s64, l64, k, stride, pad)
    got = cw.conv3d_wgrad(s, l, k, stride, pad)
    again = cw.conv3d_wgrad(s, l, k, stride, pad)
    torch.cuda.synchronize()
    assert cw.conv3d_wgrad.launches == before + 3
    assert got.shape == want.shape == (s.shape[-1], l.shape[-1], k, k, k)
    assert got64.dtype == torch.float64 and got.dtype == torch.float32
    assert ((got64 - want).abs() <= 1e-12 * abs_sum).all()
    pl = cw.plan(1, tuple(s.shape[1:4]), s.shape[-1], l.shape[-1], k, stride, torch.float32,
                 cw._vec(s, l), cuda.index or 0)
    npos = pl.brick[0] * pl.brick[1] * pl.brick[2]
    bricks = 1
    for n, b in zip(s.shape[1:4], pl.brick):
        bricks *= -(-n // b)
    depth = -(-bricks // pl.grid_x) * -(-npos // pl.groups) + pl.groups + pl.grid_x
    assert ((got.double() - got64).abs() <= (depth + 1) * 2.0 ** -24 * abs_sum).all()
    assert torch.equal(got, again)


def test_conv3d_wgrad_deep_unet_widths_against_cudnn(cuda):
    """The deep UNet's widest convs (128 -> 256 at 25 -> 13, 256 -> 256 at
    13^3, the 256 -> 128 transposed conv from 13^3) and its first (10 -> 32
    at 100^3): the kernel against cuDNN's weight gradient in float64 (1e-12
    of the largest |dW|), and both timed in fp32 (printed)."""
    from real_robot_nerf_actor_tpu_torch.ops import conv3d_wgrad_cuda as cw
    for case in [("conv", 128, 256, 3, 2, 25), ("conv", 256, 256, 3, 1, 13),
                 ("transposed", 256, 128, 3, 2, 13), ("conv", 10, 32, 3, 1, 100)]:
        kind, cin, cout, k, stride, side = case
        times = {}
        for dtype in (torch.float64, torch.float32):
            s, l, pad = _wgrad_operands(cuda, *case, seed=3, dtype=dtype)
            x, g = (s, l) if kind == "transposed" else (l, s)
            w = torch.zeros((cin, cout, k, k, k) if kind == "transposed"
                            else (cout, cin, k, k, k), device=cuda, dtype=dtype)

            def cudnn():
                return torch.ops.aten.convolution_backward(
                    g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w, None, (stride,) * 3,
                    (pad,) * 3, (1, 1, 1), kind == "transposed", (0, 0, 0), 1,
                    (False, True, False))[1]

            def kernel():
                return cw.conv3d_wgrad(s, l, k, stride, pad)

            if dtype == torch.float64:
                want, got = cudnn(), kernel()
                assert (got - want).abs().max() <= 1e-12 * want.abs().max()
                continue
            for name, fn in (("kernel", kernel), ("cudnn", cudnn)):
                fn()
                torch.cuda.synchronize()
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(5):
                    fn()
                t1.record()
                torch.cuda.synchronize()
                times[name] = t0.elapsed_time(t1) / 5
        print(f"conv3d_wgrad deep {case}: kernel {times['kernel']:.3f} ms, "
              f"cuDNN {times['cudnn']:.3f} ms")


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_unet_train_gradients_through_the_wgrad_kernel(cuda, deep):
    """The UNets' train-mode gradients on the card through Conv3dWgrad (the
    kernel) against the plain convs (cuDNN: F.conv3d and F.conv_transpose3d
    in place of the route) on the same weights and input, in float64:
    within 1e-12 of each gradient's largest |g|; 11 calls."""
    import contextlib
    import copy

    import torch.nn.functional as F

    from real_robot_nerf_actor_tpu_torch.models import blocks as tb
    from real_robot_nerf_actor_tpu_torch.ops import conv3d_wgrad_cuda as cw
    cls = tb.MultiLayer3DEncoder if deep else tb.MultiLayer3DEncoderShallow
    m = tb.init_weights(cls(10, 64), torch.Generator().manual_seed(0)).double().to(cuda)
    ref = copy.deepcopy(m)
    plain = pytest.MonkeyPatch()
    x = _randn((1, 24, 24, 24, 10), 4).double().to(cuda)
    r = None
    grads = []
    for net in (m, ref):
        if net is ref:
            plain.setattr(cw, "conv3d", F.conv3d)
            plain.setattr(cw, "conv_transpose3d", F.conv_transpose3d)
        with contextlib.ExitStack() as stack:
            stack.callback(plain.undo)
            xi = x.clone().requires_grad_()
            out = net(xi, train=True)
            out = out[0] if isinstance(out, tuple) else out
            r = _randn(tuple(out.shape), 5).double().to(cuda) if r is None else r
            before = cw.conv3d_wgrad.launches
            (out * r).sum().backward()
        grads.append({"input": xi.grad, **{n: p.grad for n, p in net.named_parameters()}})
        assert cw.conv3d_wgrad.launches - before == (11 if net is m else 0)
    for name, want in grads[1].items():
        got = grads[0][name]
        assert (got - want).abs().max() <= 1e-12 * want.abs().max(), name
