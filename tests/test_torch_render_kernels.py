"""Plain versions of the serving renderer's four Hopper kernels against the
JAX package's Pallas kernels (interpret mode on the CPU), and the host
helpers of the fused MLP against the JAX ones:

  corner_lerp_plain                  vs ops/lerp_pallas.corner_lerp
  ray_expand_plain                   vs ops/ray_expand_pallas.ray_expand
  fused_resnetfc_int8_plain          vs ops/resnetfc_pallas.fused_resnetfc_int8
  fused_gather_resnetfc_int8_plain   vs ops/resnetfc_pallas.fused_gather_resnetfc_int8

Each check also shows that a plausibly wrong kernel would fail it: a lerp
that drops the last corner or the ragged row tail, an index clipped to
[0, dim-1] instead of [-1, dim-1], int8 rounding half away from zero
(roundf) instead of half to even, a latent injection dropped at block 2.
Tolerances are stated at each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops import grid_sample as jgs
from real_robot_nerf_actor_tpu.ops import resnetfc_pallas as jrf
from real_robot_nerf_actor_tpu.ops.lerp_pallas import corner_lerp as jax_corner_lerp
from real_robot_nerf_actor_tpu.ops.ray_expand_pallas import ray_expand as jax_ray_expand
from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf
from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp, corner_lerp_plain
from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import (
    ray_expand, ray_expand_plain)

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
DL, DH, NB, NF = 8, 32, 3, 6


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ corner_lerp
@pytest.mark.parametrize("m,dtype", [(1000, np.float32), (2500, "bfloat16")])
def test_corner_lerp_plain_matches_jax(m, dtype):
    """Ragged M (the TPU kernel pads to 1024-row blocks). fp32: 1e-6
    relative (eight products summed in another order); bf16 output: one
    bf16 ulp of each value (at most 2^-7 of it) where the fp32 sums round
    apart."""
    rng = np.random.default_rng(0)
    rows = jnp.asarray(rng.standard_normal((m, 8 * 16)).astype(np.float32))
    if dtype == "bfloat16":
        rows = rows.astype(jnp.bfloat16)
    w = jnp.asarray(rng.uniform(0, 1, (8, m)).astype(np.float32))
    want = np.asarray(jax_corner_lerp(rows, w), np.float32)
    rows_t = _t(rows.astype(jnp.float32)).to(torch.bfloat16 if dtype == "bfloat16"
                                              else torch.float32)
    got = corner_lerp(rows_t, _t(w))
    assert got.dtype == rows_t.dtype and got.shape == (m, 16)
    got = got.float().numpy()
    tol = 1e-6 * np.abs(want).max() if dtype == np.float32 else \
        2 ** -7 * np.abs(want) + 1e-6
    assert np.all(np.abs(got - want) <= tol)
    # a lerp that drops the last corner, or the ragged tail past the last
    # whole 64-row block, fails the same check
    no_last = corner_lerp_plain(rows_t, _t(w) * torch.tensor([1.0] * 7 + [0.0])[:, None])
    assert np.any(np.abs(no_last.float().numpy() - want) > tol)
    cut = got.copy()
    cut[m // 64 * 64:] = 0.0
    assert np.any(np.abs(cut - want) > tol)


# ------------------------------------------------------------- ray_expand
def _rays(r=256, k=5, seed=0):
    """Rays whose samples leave the grid through every face."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(BOUNDS[:3]), np.array(BOUNDS[3:])
    ext = hi - lo
    o = rng.uniform(lo - 0.3 * ext, hi + 0.3 * ext, (r, 3))
    d = rng.standard_normal((r, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.full((r, 1), 0.1), np.full((r, 1), 2.0)], 1)
    z = np.sort(rng.uniform(0.0, 0.4, (r, k)), axis=1)
    return rays.astype(np.float32), z.astype(np.float32)


def test_ray_expand_plain_matches_jax():
    """R = 512 (two 256-ray blocks), K = 5 != R, grid 6 x 7 x 9, points
    outside the grid on every face. Indices and weights equal, up to points
    whose grid coordinate lies within 1e-5 of a cell boundary (the two
    frameworks may fuse o + z*d differently there); aux equal to one bf16
    ulp."""
    rays, z = _rays(512)
    dims = (6, 7, 9)
    aux_j, w8_j, flat_j = (np.asarray(a) for a in jax_ray_expand(
        jnp.asarray(rays), jnp.asarray(z), dims, BOUNDS, NF, 1.5, bn=256))
    aux_t, w8_t, flat_t = ray_expand(_t(rays), _t(z), dims, BOUNDS, NF, 1.5)
    assert aux_t.shape == aux_j.shape and w8_t.shape == w8_j.shape
    canon = aux_t[:3].float().numpy()
    for i in range(3):
        assert (canon[i] < -0.05).any() and (canon[i] > 1.05).any()
    # grid coordinates (fp32) to find the boundary cases
    pts = rays[None, :, :3] + z.T[..., None] * rays[None, :, 3:6]
    g = (pts - np.array(BOUNDS[:3])) / (np.array(BOUNDS[3:]) - np.array(BOUNDS[:3])) \
        * (np.array(dims[::-1]) - 1)
    edge = (np.abs(g - np.round(g)) < 1e-5).any(-1)
    ok = ~edge
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(flat_t.numpy()[ok], flat_j[ok])
    np.testing.assert_allclose(w8_t.numpy()[:, ok], w8_j[:, ok], atol=1e-6, rtol=0)
    a, b = aux_t.float().numpy(), np.asarray(aux_j, np.float32)
    assert np.all(np.abs(a - b) <= 2 ** -7 * np.abs(b) + 1e-6)
    # an index clipped to [0, dim-1] before the +1 shift (a kernel that
    # forgets the grid's low padding row) fails the index check
    low = ok & (g < 0).any(-1) & (g > -1).all(-1)
    assert low.any()
    x0 = np.floor(g[..., 0]).astype(np.int32)
    wrong = np.clip(x0, 0, dims[2] - 1) + 1
    right = np.clip(x0, -1, dims[2] - 1) + 1
    assert np.any((wrong != right)[ok])


def test_ray_expand_refuses_unpadded_rays():
    rays, z = _rays(200)
    with pytest.raises(ValueError, match="multiple of 256"):
        ray_expand(_t(rays), _t(z), (4, 4, 4), BOUNDS)


# --------------------------------------------------------- fused ResnetFC
def _mlp_params(seed=0, d_in=42, combine=3):
    rng = np.random.default_rng(seed)

    def dense(i, o, s=None):
        s = s or (2.0 / i) ** 0.5
        return {"kernel": rng.standard_normal((i, o)).astype(np.float32) * s,
                "bias": rng.standard_normal(o).astype(np.float32) * 0.1}

    p = {"Dense_0": dense(d_in, DH)}
    for i in range(min(combine, NB)):
        p[f"lin_z_{i}"] = dense(DL, DH)
    for i in range(NB):
        p[f"ResnetBlockFC_{i}"] = {"Dense_0": dense(DH, DH), "Dense_1": dense(DH, DH)}
    p["lin_out_kernel"] = rng.standard_normal((DH, 4 + 16)).astype(np.float32) * 0.2
    p["lin_out_bias"] = rng.standard_normal(4 + 16).astype(np.float32) * 0.1
    return p


def _port_state(p):
    from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
    return flax_to_state_dict({"params": p})


def _zi(n=600, seed=1):
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((n, DL)).astype(np.float32)
    canon = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    return latent, canon, dirs


def _packs(combine=3, quantize=True):
    p = _mlp_params(combine=combine)
    jp = jrf.pack_resnetfc_params(jax.tree_util.tree_map(jnp.asarray, p), d_latent=DL,
                                  num_freqs=NF, d_hidden=DH, n_blocks=NB,
                                  combine_layer=combine, quantize=quantize)
    tp = rf.pack_resnetfc_params(_port_state(p), d_latent=DL, num_freqs=NF, d_hidden=DH,
                                 n_blocks=NB, combine_layer=combine, quantize=quantize)
    return jp, tp


@pytest.mark.parametrize("quantize", [True, False])
def test_pack_and_input_match_jax(quantize):
    """Packed weights equal (same casts, same fp32 quantization); the
    packed input row equal."""
    jp, tp = _packs(quantize=quantize)
    for k, v in jp.items():
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v, np.float32),
                                      err_msg=k)
    latent, canon, dirs = _zi()
    want = jrf.pack_mlp_input(jnp.asarray(latent), jnp.asarray(canon), jnp.asarray(dirs),
                              NF, 1.5)
    got = rf.pack_mlp_input(_t(latent), _t(canon), _t(dirs), NF, 1.5)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    kp = tp["kernel"]
    assert kp["wq"].shape == (2 * NB, DH, DH) and kp["w_in"].shape == (DH, 80)


def _zi_pair():
    latent, canon, dirs = _zi()
    zi_j = jrf.pack_mlp_input(jnp.asarray(latent), jnp.asarray(canon),
                              jnp.asarray(dirs), NF, 1.5)
    return zi_j, _t(zi_j.astype(jnp.float32)).to(torch.bfloat16)


def test_capture_act_amax_matches_jax():
    """Abs-max of bf16 activations: one bf16 ulp (2^-7 relative)."""
    jp, tp = _packs(quantize=False)
    zi_j, zi_t = _zi_pair()
    want = np.asarray(jrf.capture_act_amax(zi_j, jp, n_blocks=NB, combine_layer=3))
    got = rf.capture_act_amax(zi_t, tp, n_blocks=NB, combine_layer=3).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7)


# tolerance of the fused MLP outputs, of each output's largest |value|: the
# fp32 sums of the first layer run in another order, which can move a bf16
# activation by one ulp and then an int8 code by one step
MLP_TOL = 2 ** -6


def _check(got, want):
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= MLP_TOL * np.abs(w).max(), np.abs(g - w).max()


def _static(scale_pow2=False):
    jp, tp = _packs(quantize=False)
    zi_j, _ = _zi_pair()
    amax = np.asarray(jrf.capture_act_amax(zi_j, jp, n_blocks=NB, combine_layer=3))
    if scale_pow2:   # exact inverses, so t * inv lands on many .5 ties
        return tuple(float(2.0 ** np.ceil(np.log2(a / 127.0))) for a in amax)
    return tuple(float(a) * 1.05 / 127.0 + 1e-8 for a in amax)


@pytest.mark.parametrize("mode", ["dynamic", "static", "static_pow2", "bf16"])
def test_fused_resnetfc_plain_matches_jax(mode):
    """N = 600 rows (not a multiple of the kernels' 64-row or the TPU's
    512-row block), dynamic and static int8 scales and quantized=False."""
    quantized = mode != "bf16"
    jp, tp = _packs(quantize=quantized)
    zi_j, zi_t = _zi_pair()
    scales = _static(mode == "static_pow2") if mode.startswith("static") else None
    want = jrf.fused_resnetfc_int8(zi_j, jp, NB, 3, quantized=quantized,
                                   act_scales=scales)
    got = rf.fused_resnetfc_int8(zi_t, tp, NB, 3, quantized=quantized,
                                 act_scales=scales)
    _check(got, want)
    # the ragged tail (rows past the last whole 64-row tile) carries
    # values the check sees
    tail = np.asarray(want[1], np.float32)[600 // 64 * 64:]
    assert np.abs(tail).max() > MLP_TOL * np.abs(np.asarray(want[1], np.float32)).max()


def _round_half_away(x):
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def test_fused_resnetfc_check_rejects_wrong_kernels(monkeypatch):
    """roundf (half away from zero) in place of half to even, under static
    power-of-two scales (exact .5 ties), and a latent injection dropped at
    block 2 (combine_layer 3), each miss the tolerance."""
    jp, tp = _packs()
    zi_j, zi_t = _zi_pair()
    scales = _static(scale_pow2=True)
    want = jrf.fused_resnetfc_int8(zi_j, jp, NB, 3, act_scales=scales)
    right = rf.fused_resnetfc_int8_plain(zi_t, tp, NB, 3, act_scales=scales)
    real_round = torch.round
    monkeypatch.setattr(rf.torch, "round", _round_half_away)
    try:
        wrong = rf.fused_resnetfc_int8_plain(zi_t, tp, NB, 3, act_scales=scales)
    finally:
        monkeypatch.setattr(rf.torch, "round", real_round)
    assert not torch.equal(wrong[1], right[1])
    with pytest.raises(AssertionError):
        _check(wrong, want)
    no_inject = rf.fused_resnetfc_int8_plain(zi_t, tp, NB, 2, act_scales=scales)
    with pytest.raises(AssertionError):
        _check(no_inject, want)


@pytest.mark.parametrize("mode", ["dynamic", "static", "bf16"])
def test_fused_gather_resnetfc_plain_matches_jax(mode):
    """Rows of a corner-expanded 6 x 7 x 9 grid (bf16), indices, weights
    and aux rows from the JAX ray_expand: N = 256 rays x 3 samples = 768
    rows (the TPU kernel pads to 1024). Same tolerance as the unfused MLP."""
    quantized = mode != "bf16"
    jp, tp = _packs(quantize=quantized)
    rng = np.random.default_rng(3)
    grid = jnp.asarray(rng.standard_normal((1, 6, 7, 9, DL)).astype(np.float32))
    exp = jgs.expand_corners(grid).astype(jnp.bfloat16)
    vox_rows = exp.reshape(-1, 8 * DL)
    rays, z = _rays(256, 3, seed=4)
    aux, w8, flat = jax_ray_expand(jnp.asarray(rays), jnp.asarray(z), (6, 7, 9), BOUNDS,
                                   NF, 1.5)
    n = flat.size
    aux, w8, flat = aux.reshape(-1, n), w8.reshape(8, n), flat.reshape(n)
    scales = _static() if mode == "static" else None
    want = jrf.fused_gather_resnetfc_int8(vox_rows, flat, w8, aux, jp, d_latent=DL,
                                          num_freqs=NF, n_blocks=NB, combine_layer=3,
                                          quantized=quantized, act_scales=scales)
    got = rf.fused_gather_resnetfc_int8(
        _t(vox_rows.astype(jnp.float32)).to(torch.bfloat16), _t(flat), _t(w8),
        _t(aux.astype(jnp.float32)).to(torch.bfloat16), tp, d_latent=DL, num_freqs=NF,
        n_blocks=NB, combine_layer=3, quantized=quantized, act_scales=scales)
    _check(got, want)


def test_static_scale_tensor_rounds_like_jax():
    """inv = 1/xs in double, rounded once to fp32, as the TPU kernel's
    Python-float constants round."""
    s = rf.static_act_scales([0.1, 3.0], "cpu")
    assert s.dtype == torch.float32 and s.shape == (2, 2)
    assert s[1, 0].item() == np.float32(1.0 / 0.1) and s[0, 1].item() == np.float32(3.0)
