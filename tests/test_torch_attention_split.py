"""The split-key path of the port's bf16 flash attention, on the CPU: the
split algebra in plain PyTorch (each chunk's (m, l, acc), then the combine)
against the one-pass plain version and the JAX Pallas kernel in interpret
mode; the split-count planner; the strided head views that `MHAttention`
hands the kernel; and the planted fault the card test holds the kernel to
(zero-filled padded keys let into the softmax). The Hopper kernels are held
against the plain versions in test_torch_kernels_cuda.py, on the card.

Tolerances as in test_torch_attention.py: fp32 1e-5 absolute; bf16 2^-6 of
the largest output (the chunks round their probabilities to bf16 against
their own running max, as the kernel's online softmax does per tile).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops.attention_pallas import flash_attention as jax_flash
from real_robot_nerf_actor_tpu_torch.models.perceiver import MHAttention
from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import (
    flash_attention, flash_attention_plain, flash_attention_split_plain, plan_splits)
from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import takes_wgmma


def _tol(dtype, want):
    return 1e-5 if dtype == "float32" else 2 ** -6 * float(np.abs(want).max())


def _qkv(heads, nq, nk, seed=0, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, heads, nq, d)).astype(np.float32),
            rng.standard_normal((1, heads, nk, d)).astype(np.float32),
            rng.standard_normal((1, heads, nk, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,nq,nk,splits", [(1, 77, 125, 2), (2, 40, 202, 3),
                                                (1, 33, 520, 8), (1, 16, 64, 1)])
def test_split_algebra_matches_one_pass_and_jax(dtype, heads, nq, nk, splits):
    q, k, v = _qkv(heads, nq, nk, seed=splits)
    tdt = getattr(torch, dtype)
    got = flash_attention_split_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                      splits)
    assert got.dtype == tdt and got.shape == (1, heads, nq, 64)
    got = got.float().numpy()
    one_pass = flash_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    one_pass = one_pass.float().numpy()
    np.testing.assert_allclose(got, one_pass, rtol=0, atol=_tol(dtype, one_pass))
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                block_q=32, block_k=128, interpret=True), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(dtype, want))


def test_split_combine_weighs_chunks_by_their_max():
    """One chunk holds every large score: the combine must weigh the other
    chunk's sums by e^(m_s - m), or the output moves to that chunk's values."""
    q = torch.ones((1, 1, 4, 64))
    k = torch.zeros((1, 1, 128, 64))
    k[:, :, :64] = 0.5                      # scores 4 in chunk 0, 0 in chunk 1
    v = torch.zeros((1, 1, 128, 64))
    v[:, :, 64:] = 1.0
    got = flash_attention_split_plain(q, k, v, 2)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert 0 < want.max().item() < 0.02      # e^0 / (e^4 + e^0) of the ones


@pytest.mark.parametrize("bh,nq,nk,want", [(1, 2048, 8077, 8), (1, 8077, 2048, 2),
                                           (8, 2048, 2048, 1), (2, 77, 125, 1),
                                           (1, 64, 64, 1), (1, 2048, 300, 1)])
def test_plan_splits(bh, nq, nk, want):
    """The policy's three shapes fill the 132 SMs once (128 blocks); small
    key ranges keep at least four 64-key tiles a split."""
    splits = plan_splits(bh, nq, nk, sms=132)
    assert splits == want
    blocks = bh * -(-nq // 128) * splits
    assert blocks <= 132 or splits == 1
    tiles = -(-nk // 64)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles          # no split is empty


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhattention_strided_views_match_before(dtype):
    """`MHAttention` hands flash_attention its split-heads views (k and v
    halves of one projection) and a view of its (B, N, H*D) output: the
    result equals the former path, which copied q, k, v contiguous and
    transposed the output back."""
    att = MHAttention(96, 80, heads=2, dim_head=64, out_dim=96, dtype=dtype,
                      use_flash=True)
    g = torch.Generator().manual_seed(0)
    for dense in (att.to_q, att.to_kv, att.to_out):
        dense.reset_parameters(g)
    x, ctx = torch.randn(2, 37, 96, generator=g), torch.randn(2, 53, 80, generator=g)
    got = att(x, ctx)

    q = att.to_q(x)
    k, v = att.to_kv(ctx).chunk(2, dim=-1)
    split = lambda t: t.reshape(t.shape[0], t.shape[1], 2, 64).transpose(1, 2)  # noqa: E731
    q, k, v = map(split, (q, k, v))
    assert not k.is_contiguous()
    before = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    before = att.to_out(before.transpose(1, 2).reshape(2, 37, -1)).float()
    torch.testing.assert_close(got, before, rtol=0, atol=0)


def test_out_is_written_in_the_callers_layout():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 9, 30, seed=4))
    out = torch.full((1, 9, 2 * 64), float("nan"))
    view = out.view(1, 9, 2, 64).transpose(1, 2)
    res = flash_attention(q, k, v, out=view)
    assert res.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out.view(1, 9, 2, 64).transpose(1, 2),
                               flash_attention_plain(q, k, v), rtol=0, atol=0)


def _padded_key_case(nk=8077, nq=256, seed=7):
    """q rows near u = ones(64), keys -3 (u + noise): every real score is
    about -24 (scale 1/8), far below the 0 that a zero-filled key scores."""
    rng = np.random.default_rng(seed)
    u = np.ones(64, np.float32)
    q = u + 0.1 * rng.standard_normal((1, 1, nq, 64)).astype(np.float32)
    k = -3.0 * (u + 0.1 * rng.standard_normal((1, 1, nk, 64)).astype(np.float32))
    v = rng.standard_normal((1, 1, nk, 64)).astype(np.float32)
    return (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))


def test_padded_keys_fault_fails_the_tolerance():
    """At 8077 keys the last 64-key tile holds 51 keys past Nk, which TMA
    reads as zeros. Let into the softmax (appended here to the plain version
    as zero keys and values), they swamp the real keys: the bf16 tolerance
    rejects it by far. The card test holds the kernel to the same inputs."""
    q, k, v = _padded_key_case()
    scores = (q.float() @ k.float().transpose(-1, -2)) * 64 ** -0.5
    assert scores.max().item() <= -20
    want = flash_attention_plain(q, k, v).float()
    pad = torch.zeros((1, 1, 51, 64), dtype=torch.bfloat16)
    faulty = flash_attention_plain(q, torch.cat([k, pad], 2), torch.cat([v, pad], 2)).float()
    tol = 2 ** -6 * want.abs().max().item()
    assert (faulty - want).abs().max().item() > 10 * tol


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (torch.bfloat16, 128, 64, True), (torch.bfloat16, 64, 24, True),
    (torch.bfloat16, 192, 200, True), (torch.bfloat16, 40, 24, False),
    (torch.bfloat16, 12, 10, False), (torch.bfloat16, 64, 20, False),
    (torch.float32, 128, 64, False)])
def test_conv_routes_shapes_to_the_wgmma_kernel(dtype, cin, cout, want):
    """bf16 with Cin a multiple of 64 and Cout a multiple of 8 takes the
    wgmma kernel; every other call the first (SIMT/WMMA) kernel."""
    x = torch.zeros((1, 3, 3, 3, cin), dtype=dtype)
    w = torch.zeros((3, 3, 3, cin, cout), dtype=dtype)
    assert takes_wgmma(x, w) is want
