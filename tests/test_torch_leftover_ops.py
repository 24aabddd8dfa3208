"""The port's last ops against the JAX package, on inputs from a numpy seed:
`composite_unsorted` (against JAX's and against the port's own `composite`
on the sorted samples), `grid_sample_3d_fastbwd` (its forward equals
`grid_sample_3d`, its grid gradient is held to JAX's custom VJP and to the
port's autograd through `grid_sample_3d`, its coords gradient is zero), the
image augmentations with JAX's draws fed in, and the generator path's
ranges; then the profiling helpers and the kernel build cache.

Tolerances (fp32): compositing 1e-5 of each output's scale (the same
arithmetic in another order; 1e-4 against the sorted path, whose
transmittance is a cumsum where the unsorted one is a masked matmul);
the fast backward's grid gradient 1e-5 of its scale against JAX's (both add
the same fp32 rows, in another order) and against autograd's (which adds
the eight corners' rows one scatter at a time); the shift exactly (a
gather); jitter and grayscale within 4e-7 absolute on images in [0, 1]
(the port rounds each mean once from a float64 sum, JAX sums in fp32: the
mean an ulp apart, carried through at most three roundings).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.data import augment as ja
from real_robot_nerf_actor_tpu.ops import compositing as jc
from real_robot_nerf_actor_tpu.ops import grid_sample as jg
from real_robot_nerf_actor_tpu_torch.data import augment as ta
from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.ops import compositing as tc
from real_robot_nerf_actor_tpu_torch.ops import grid_sample as tg
from real_robot_nerf_actor_tpu_torch.utils import StepTimer, named_scope
from real_robot_nerf_actor_tpu_torch.utils import cache, profiling

AUG_TOL = 4e-7


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _rays(rng, b):
    o = rng.standard_normal((b, 3)).astype(np.float32)
    d = rng.standard_normal((b, 3)).astype(np.float32)
    return np.concatenate([o, d / np.linalg.norm(d, axis=-1, keepdims=True),
                           np.full((b, 1), 1.2, np.float32),
                           np.full((b, 1), 4.0, np.float32)], -1)


def _composite_inputs(seed, b=6, k=96, ties=False):
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.2, 4.0, (b, k)).astype(np.float32)
    if ties:   # equal depths: the stable-argsort tie rule decides the order
        z[:, k // 2:k // 2 + 4] = z[:, :1]
    return (z, _rays(rng, b), rng.uniform(0, 1, (b, k, 3)).astype(np.float32),
            rng.exponential(1.0, (b, k)).astype(np.float32),
            rng.standard_normal((b, k, 5)).astype(np.float32))


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_composite_unsorted_matches_jax(white_bkgd, ties):
    args = _composite_inputs(0, ties=ties)
    want = jc.composite_unsorted(*(jnp.asarray(a) for a in args), white_bkgd=white_bkgd)
    got = tc.composite_unsorted(*(torch.from_numpy(a) for a in args), white_bkgd=white_bkgd)
    for name in ("weights", "rgb", "embed", "depth"):
        _close(getattr(got, name), getattr(want, name), 1e-5, name)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite_unsorted_matches_sorted_composite(white_bkgd):
    """The weights come back in the input order: gathered by the argsort,
    they are the sorted path's; rgb, embed and depth are the sorted
    path's."""
    z, rays, rgbs, sig, emb = (torch.from_numpy(a) for a in _composite_inputs(1))
    order = torch.argsort(z, dim=-1, stable=True)
    srt = tc.composite(torch.gather(z, 1, order), rays,
                       torch.gather(rgbs, 1, order[..., None].expand_as(rgbs)),
                       torch.gather(sig, 1, order),
                       torch.gather(emb, 1, order[..., None].expand_as(emb)),
                       white_bkgd=white_bkgd)
    uns = tc.composite_unsorted(z, rays, rgbs, sig, emb, white_bkgd=white_bkgd)
    _close(torch.gather(uns.weights, 1, order), srt.weights.numpy(), 1e-4, "weights")
    for name in ("rgb", "embed", "depth"):
        _close(getattr(uns, name), getattr(srt, name).numpy(), 1e-4, name)


def _grid_case(seed, shape=(2, 5, 6, 7, 4), n=300):
    rng = np.random.default_rng(seed)
    grid = rng.standard_normal(shape).astype(np.float32)
    # some samples outside [-1, 1]: their out-of-bounds corners weigh zero
    coords = rng.uniform(-1.3, 1.3, (shape[0], n, 3)).astype(np.float32)
    cot = rng.standard_normal((shape[0], n, shape[-1])).astype(np.float32)
    return grid, coords, cot


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 4), (1, 20, 20, 20, 8)])
def test_fastbwd_matches_jax_and_autograd(shape):
    grid, coords, cot = _grid_case(2, shape)
    want_out, vjp = jax.vjp(lambda g: jg.grid_sample_3d_fastbwd(g, jnp.asarray(coords)),
                            jnp.asarray(grid))
    (want_g,) = vjp(jnp.asarray(cot))

    g_fast = torch.from_numpy(grid).requires_grad_()
    out = tg.grid_sample_3d_fastbwd(g_fast, torch.from_numpy(coords))
    (out * torch.from_numpy(cot)).sum().backward()
    g_auto = torch.from_numpy(grid).requires_grad_()
    ref = tg.grid_sample_3d(g_auto, torch.from_numpy(coords))
    (ref * torch.from_numpy(cot)).sum().backward()

    assert torch.equal(out, ref)
    _close(out, want_out, 1e-5, "forward vs JAX")
    _close(g_fast.grad, want_g, 1e-5, "d grid vs JAX's custom VJP")
    _close(g_fast.grad, g_auto.grad.numpy(), 1e-5, "d grid vs autograd")


def test_fastbwd_coords_gradient_is_zero_and_dtype_kept():
    """The coords get zeros; a bf16 grid gets its gradient summed in fp32
    and cast once: exactly the fp32 path's gradient on the same bf16 values
    and cotangent, rounded to bf16."""
    grid, coords, cot = _grid_case(3)
    g = torch.from_numpy(grid).to(torch.bfloat16).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    out = tg.grid_sample_3d_fastbwd(g, c)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert c.grad is not None and not c.grad.any()
    assert g.grad.dtype == torch.bfloat16
    g32 = g.detach().float().requires_grad_()
    out32 = tg.grid_sample_3d_fastbwd(g32, torch.from_numpy(coords))
    (out32 * torch.from_numpy(cot).to(torch.bfloat16).float()).sum().backward()
    assert torch.equal(g.grad, g32.grad.to(torch.bfloat16))


def _images(seed, shape=(6, 10, 12, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("pad", [4, 2])
def test_random_shift_equals_jax(pad):
    x = _images(4)
    key = jax.random.key(5)
    want = np.asarray(ja.random_shift(key, jnp.asarray(x), pad))
    k1, k2 = jax.random.split(key)
    ox = np.array(jax.random.randint(k1, (x.shape[0],), 0, 2 * pad + 1))
    oy = np.array(jax.random.randint(k2, (x.shape[0],), 0, 2 * pad + 1))
    got = ta.random_shift(torch.from_numpy(x), pad,
                          offsets=(torch.from_numpy(oy), torch.from_numpy(ox)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_color_jitter_and_grayscale_match_jax():
    x = _images(6)
    b = x.shape[0]
    key = jax.random.key(7)
    want = np.asarray(ja.color_jitter(key, jnp.asarray(x), 0.4, 0.3, 0.5))
    kb, kc, ks = jax.random.split(key, 3)
    factors = [torch.from_numpy(np.asarray(
        1.0 + jax.random.uniform(k, (b, 1, 1, 1), minval=-a, maxval=a)))
        for k, a in ((kb, 0.4), (kc, 0.3), (ks, 0.5))]
    got = ta.color_jitter(torch.from_numpy(x), 0.4, 0.3, 0.5, factors=factors)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_TOL)

    key = jax.random.key(8)
    want = np.asarray(ja.random_grayscale(key, jnp.asarray(x), p=0.5))
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (b, 1, 1, 1))))
    got = ta.random_grayscale(torch.from_numpy(x), p=0.5, u=u)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_TOL)
    assert 0 < int((u < 0.5).sum()) < b   # both branches taken


def test_augment_generator_path_ranges():
    x = torch.from_numpy(_images(9, (64, 8, 8, 3)))
    g = torch.Generator().manual_seed(0)
    shifted = ta.random_shift(x, 4, generator=g)
    # each output is the edge-padded image at some offset in [0, 8]^2
    padded = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (4,) * 4,
                                     mode="replicate").permute(0, 2, 3, 1)
    seen = set()
    for i in range(x.shape[0]):
        hits = [(oy, ox) for oy in range(9) for ox in range(9)
                if torch.equal(padded[i, oy:oy + 8, ox:ox + 8], shifted[i])]
        assert hits, i
        seen.update(hits)
    assert len(seen) > 20
    out = ta.color_jitter(x, generator=g)
    assert out.shape == x.shape and out.min() >= 0 and out.max() <= 1
    assert not torch.equal(out, x)
    gray = ta.random_grayscale(x, p=0.5, generator=g)
    is_gray = (gray[..., :1] == gray).all(dim=(1, 2, 3))
    untouched = (gray == x).all(dim=(1, 2, 3))
    assert bool((is_gray | untouched).all()) and 5 < int(is_gray.sum()) < 59
    # the same generator state gives the same draws
    a = ta.random_shift(x, 4, generator=torch.Generator().manual_seed(3))
    b = ta.random_shift(x, 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_named_scope_appears_in_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with named_scope("renderer_composite"):
            torch.ones(8).sum()
    assert "renderer_composite" in {e.name for e in prof.events()}


def test_step_timer_and_trace_write_a_readable_file(tmp_path):
    x = torch.ones(64)
    with StepTimer(sync_on={"a": [x, (x,)]}) as t:
        y = (x * 2).sum()
    assert t.seconds > 0 and float(y) == 128.0
    with profiling.trace(str(tmp_path)) as prof:
        with named_scope("model_inference"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "model_inference" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_enable_persistent_cache_points_the_kernel_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)   # restored after
    default = _build.BUILD_DIR
    assert default == Path(_build.__file__).resolve().parent.parent / ".build"
    assert cache.enable_persistent_cache() == str(default) and _build.BUILD_DIR == default
    target = tmp_path / "kernels"
    assert cache.enable_persistent_cache(str(target)) == str(target)
    assert target.is_dir() and _build.BUILD_DIR == target
    assert cache.enable_persistent_cache(str(target)) == str(target)   # idempotent
    assert _build.BUILD_DIR == target
    assert str(_build._lib_path("corner_lerp")).startswith(str(target))
