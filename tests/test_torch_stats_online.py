"""The scheme of the CUDA spatial_stats_3d kernel (csrc/spatial_stats.cu),
mirrored in plain PyTorch at the kernel's own cut (`stats_cuda.plan`), held
against the JAX Pallas kernel under force_tpu_interpret_mode:

  per thread-row of a block, for each ring stage: the stage's channel max,
  the running sums rescaled by exp2((m_old - m_new) k) where it rose, then
  the terms exp2((x - m) k) [1, lin[y], lin[z], lin[x]]; the block's
  thread-rows merged per slab, the slab partials folded by groups of
  FOLD_GROUP slabs, then the groups' (each fold in the kernel's fixed order:
  lanes merging strided entries one by one, then a butterfly).

This runs the kernel's arithmetic (fp32, exp2 with k = log2(e)/T) where a
CUDA kernel cannot run, so the tolerance that chip_smoke.py holds the kernel
to, 1e-5 of each channel's denominator, is seen to hold for the scheme at
input scales 0.3 and 0.01, with a slab whose channel max lies so far below
the global one that its factor underflows to 0, and with a slab that is
-inf throughout in one channel. A mirror that forgets the rescale fails
that tolerance by far.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from real_robot_nerf_actor_tpu.ops.stats_pallas import spatial_stats_3d as jax_stats
from real_robot_nerf_actor_tpu_torch.ops import stats_cuda
from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import plan, spatial_stats_3d_plain

NEG = float("-inf")


def merge(M, S, m2, s2, k):
    """The kernel's `merge`: both rescaled to the larger max; two empty ones
    (-inf) stay empty."""
    mn = torch.maximum(M, m2)
    empty = mn == NEG
    f1 = torch.where(empty, 0.0, torch.exp2((M - mn) * k))
    f2 = torch.where(empty, 0.0, torch.exp2((m2 - mn) * k))
    return torch.where(empty, M, mn), torch.where(empty, S, S * f1 + s2 * f2)


def fold(Ms, Ss, k, items):
    """The kernel's `fold_range` over the first axis of Ms (n, ...) and Ss
    (4, n, ...): lane j of `tpi` merges entries j, j + tpi, ... in order,
    then the lanes merge in a butterfly. Returns (M, S)."""
    tpi = 1
    while tpi < 32 and 2 * tpi * items <= stats_cuda.THREADS:
        tpi *= 2
    lanes = []
    for j in range(tpi):
        M, S = torch.full(Ms.shape[1:], NEG), torch.zeros(Ss.shape[:1] + Ss.shape[2:])
        for i in range(j, Ms.shape[0], tpi):
            M, S = merge(M, S, Ms[i], Ss[:, i], k)
        lanes.append((M, S))
    d = 1
    while d < tpi:
        lanes = [merge(*lanes[j], *lanes[j ^ d], k) for j in range(tpi)]
        d *= 2
    return lanes[0]


def online_stats(x, temperature, pl, rescale=True):
    """x (B, V, V, V, C) fp32 (the values the kernel reads) -> (B, C, 4)."""
    b, v, _, _, c = x.shape
    n_rows = v ** 3
    k = torch.tensor(np.float32(np.log2(np.e) / temperature))
    lin = torch.arange(v, dtype=torch.float32) * np.float32(2.0 / (v - 1)) - 1.0
    r = torch.arange(n_rows)
    pos = torch.stack([lin[(r // v) % v], lin[r // (v * v)], lin[r % v]])  # y, z, x
    total = pl.slabs * pl.rows_per_slab
    xs = torch.full((b, total, c), NEG)
    xs[:, :n_rows] = x.reshape(b, n_rows, c)
    ps = torch.zeros((3, total))
    ps[:, :n_rows] = pos
    n_st = pl.rows_per_slab // pl.stage_rows
    side, per = pl.rows_side_by_side, pl.rows_per_thread
    # row j * side + t of a stage belongs to thread-row t
    xs = xs.reshape(b, pl.slabs, n_st, per, side, c)
    ps = ps.reshape(3, pl.slabs, n_st, per, side)
    m = torch.full((b, pl.slabs, side, c), NEG)
    s = torch.zeros((4, b, pl.slabs, side, c))
    for i in range(n_st):
        blk = xs[:, :, i]                                     # (b, slabs, per, side, c)
        mx = blk.amax(dim=2)
        rise = mx > m
        if rescale:
            s = torch.where(rise, s * torch.exp2((m - mx) * k), s)
        m = torch.where(rise, mx, m)
        ms = torch.where(m == NEG, 0.0, m)
        e = torch.exp2((blk - ms[:, :, None]) * k)
        for j in range(per):   # the rows of a thread in order
            s[0] += e[:, :, j]
            for q in range(3):
                s[q + 1] += e[:, :, j] * ps[q][:, i, j][None, :, :, None]
    # the block merge over its thread-rows, then the folds: each group of
    # FOLD_GROUP slabs, then the groups
    M, P = fold(m.permute(2, 0, 1, 3), s.permute(0, 3, 1, 2, 4), k, c)  # (b, slabs, c)
    gms, gss = [], []
    for g0 in range(0, pl.slabs, stats_cuda.FOLD_GROUP):
        sl = slice(g0, g0 + stats_cuda.FOLD_GROUP)
        gm, gs = fold(M[:, sl].transpose(0, 1), P[:, :, sl].transpose(1, 2), k, c)
        gms.append(gm)
        gss.append(gs)
    _, S = fold(torch.stack(gms), torch.stack(gss, dim=1), k, b * c)
    return S.permute(1, 2, 0)


def _feature(shape, dtype, scale, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(getattr(torch, dtype)).float()


def _jax(x, dtype):
    with pltpu.force_tpu_interpret_mode():
        return torch.from_numpy(np.array(jax_stats(jnp.asarray(x.numpy(), getattr(jnp, dtype)))))


def _err_of_den(got, want):
    return ((got - want).abs() / want[..., :1]).max().item()


CASES = [((1, 48, 48, 48, 4), "float32"),    # bulk route, 18 slabs: two fold groups
         ((2, 24, 24, 24, 8), "bfloat16"),   # bulk route, 2 batches of 3 slabs
         ((1, 16, 16, 16, 6), "float32")]    # 24-byte rows: plain loads


@pytest.mark.parametrize("scale", [0.3, 0.01])
@pytest.mark.parametrize("shape,dtype", CASES)
def test_online_scheme_matches_jax_kernel(shape, dtype, scale):
    x = _feature(shape, dtype, scale)
    elt = 4 if dtype == "float32" else 2
    pl = plan(shape, elt)
    assert pl.slabs > 1 and pl.bulk == (shape[-1] * elt % 16 == 0)
    assert pl.fold_groups == (2 if shape[1] == 48 else 1)
    want = _jax(x, dtype)
    got = online_stats(x, 0.01, pl)
    assert _err_of_den(got, want) <= 1e-5
    assert _err_of_den(got, spatial_stats_3d_plain(x)) <= 1e-5
    if scale == 0.3:
        # without the rescale the early terms keep their stale max: far off
        assert _err_of_den(online_stats(x, 0.01, pl, rescale=False), want) > 1e3 * 1e-5


@pytest.mark.parametrize("shape,dtype", CASES[:2])
def test_online_scheme_edge_slabs(shape, dtype):
    """Channel 0 of slab 1 lies 40 below the rest (its fold factor
    exp2(-40 k) underflows to 0); channel 1 of the last slab is -inf
    throughout (m = -inf: it adds 0, and no -inf - -inf is formed)."""
    elt = 4 if dtype == "float32" else 2
    pl = plan(shape, elt)
    x = _feature(shape, dtype, 0.3, seed=3)
    b, v, _, _, c = shape
    flat = x.reshape(b, v ** 3, c)
    r0, r1 = pl.rows_per_slab, 2 * pl.rows_per_slab
    flat[:, r0:r1, 0] -= 40.0
    flat[:, (pl.slabs - 1) * pl.rows_per_slab:, 1] = NEG
    x = flat.reshape(shape)
    want = _jax(x, dtype)
    got = online_stats(x, 0.01, pl)
    assert torch.isfinite(got).all()
    assert _err_of_den(got, want) <= 1e-5


@pytest.mark.parametrize("shape,elt", [((1, 100, 100, 100, 64), 4),
                                       ((1, 20, 20, 20, 128), 4),
                                       ((1, 100, 100, 100, 64), 2)])
def test_plan_of_the_act_step_shapes(shape, elt):
    """The act step's three volumes take the bulk ring: 32 KB stages of
    whole rows, slabs of whole stages for two blocks on each of 132 SMs
    (fewer for the small dec volume, at least one ring of stages each)."""
    pl = plan(shape, elt)
    n_rows = shape[1] ** 3
    assert pl.bulk and pl.groups == 1
    assert pl.stage_rows * shape[-1] * elt == stats_cuda.STAGE_BYTES
    assert pl.rows_per_slab % pl.stage_rows == 0
    assert (pl.slabs - 1) * pl.rows_per_slab < n_rows <= pl.slabs * pl.rows_per_slab
    assert pl.slabs <= 132 * stats_cuda.BLOCKS_PER_SM
    assert pl.rows_per_slab >= stats_cuda.STAGES * pl.stage_rows


def test_plan_routes():
    """Plain loads for rows that are not whole 16 bytes, an unaligned base,
    or more than 2048 channels (in groups of 512)."""
    assert not plan((1, 8, 8, 8, 6), 4).bulk
    assert not plan((1, 8, 8, 8, 4), 2).bulk            # 8-byte rows
    assert not plan((1, 8, 8, 8, 64), 4, data_ptr=8).bulk
    big = plan((1, 8, 8, 8, 3000), 4)
    assert not big.bulk and big.groups == 6
    assert plan((1, 8, 8, 8, 2048), 4).bulk
