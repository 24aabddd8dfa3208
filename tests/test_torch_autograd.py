"""Gradients of the port's kernel wrappers on their CUDA branch, checked on
the CPU through the module-level launcher of each wrapper (`_launch`),
which these tests replace: by the plain forward where a gradient is
computed, by a recorder where only the routing matters.

  conv3d_k3, corner_lerp: `torch.autograd.Function`s whose backward is the
    JAX package's custom VJP. Held against `jax.vjp` of the JAX functions
    (`conv3d_pallas.conv3d_k3`, `lerp_pallas.corner_lerp` in interpret
    mode) and against autograd of the plain versions.
  flash_attention, spatial_stats_3d, ray_expand, fused_resnetfc_int8,
  fused_gather_resnetfc_int8: no VJP in the reference, so their CUDA
    branch raises under grad mode when an input requires a gradient, before
    it launches anything, and runs as before under no_grad and
    inference_mode. Meta tensors reach that branch here (only a CPU tensor
    takes the plain version).

Tolerances: fp32 1e-5 of each gradient's largest |value| (sums of 27*Cin
or C products in another order); bf16 2^-7 of it, one bf16 rounding of a
gradient that the two sides compute with fp32 sums in another order (the
JAX conv rounds dx to bf16 and keeps dk in fp32; the port's dk is in the
kernel's dtype, bf16 on that path, so its rounding counts too). The conv's
bias gradient is an fp32 sum on both sides, 1e-5 (see `_jax_db`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops.conv3d_pallas import conv3d_k3 as jax_conv3d_k3
from real_robot_nerf_actor_tpu.ops.lerp_pallas import corner_lerp as jax_corner_lerp
from real_robot_nerf_actor_tpu_torch.ops import (
    attention_cuda, conv3d_cuda, lerp_cuda, ray_expand_cuda, resnetfc_cuda, stats_cuda)
from real_robot_nerf_actor_tpu_torch.ops._grad import refuse_grad


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tol(dtype, want):
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    return (1e-5 if dtype == "float32" else 2 ** -7) * scale


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(dtype, want))


@pytest.fixture
def plain_launchers(monkeypatch):
    """The two Functions launch their plain forward: CPU tensors through
    the CUDA branch's autograd wiring."""
    monkeypatch.setattr(conv3d_cuda, "_launch", conv3d_cuda.conv3d_k3_plain)
    monkeypatch.setattr(lerp_cuda, "_launch", lerp_cuda.corner_lerp_plain)


# ---------------------------------------------------------------- conv3d_k3
def _conv_inputs(dtype, with_bias, seed=0, shape=(1, 6, 6, 6, 8), cout=4):
    x = _rand(shape, seed)
    w = _rand((3, 3, 3, shape[-1], cout), seed + 1, 0.2)
    b = _rand((cout,), seed + 2) if with_bias else None
    g = _rand(shape[:-1] + (cout,), seed + 3)
    return x, w, b, g


def _torch_conv_grads(x, w, b, g, dtype, fn):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    y = fn(xt, wt, bt)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(g).to(tdt))
    return y, xt.grad, wt.grad, None if bt is None else bt.grad


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_k3_backward_matches_jax_vjp(plain_launchers, dtype, with_bias):
    x, w, b, g = _conv_inputs(dtype, with_bias)
    jdt = getattr(jnp, dtype)
    args = (jnp.asarray(x, jdt), jnp.asarray(w, jdt)) + (
        () if b is None else (jnp.asarray(b),))
    _, vjp = jax.vjp(jax_conv3d_k3, *args)
    want = vjp(jnp.asarray(g, jdt))
    launches = conv3d_cuda.conv3d_k3.launches
    _, dx, dk, db = _torch_conv_grads(x, w, b, g, dtype, conv3d_cuda.Conv3dK3.apply)
    assert conv3d_cuda.conv3d_k3.launches == launches   # the launcher was replaced
    assert dx.dtype == dk.dtype == getattr(torch, dtype)
    _close(dx, want[0], dtype)
    _close(dk, want[1], dtype)
    if with_bias:
        assert db.dtype == torch.float32
        _close(db, _jax_db(g, dtype), "float32")


def _jax_db(g, dtype):
    """The bias gradient of the JAX VJP with fp32 sums of g (rounded to
    `dtype` first). On bf16 the JAX VJP returns db in bf16, summed in bf16
    by XLA on the CPU (4% off at 216 terms here); the port sums in fp32."""
    g32 = jnp.asarray(g, getattr(jnp, dtype)).astype(jnp.float32)
    x0 = jnp.zeros(g.shape[:-1] + (1,), jnp.float32)
    w0 = jnp.zeros((3, 3, 3, 1, g.shape[-1]), jnp.float32)
    _, vjp = jax.vjp(jax_conv3d_k3, x0, w0, jnp.zeros((g.shape[-1],), jnp.float32))
    return vjp(g32)[2]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_k3_function_matches_plain_autograd(plain_launchers, dtype, with_bias):
    """The Function's gradients against autograd of conv3d_k3_plain on the
    same inputs, at a volume that is no cube (the plain version's taps run
    over every axis)."""
    x, w, b, g = _conv_inputs(dtype, with_bias, seed=4, shape=(2, 5, 7, 4, 6), cout=3)
    y, dx, dk, db = _torch_conv_grads(x, w, b, g, dtype, conv3d_cuda.Conv3dK3.apply)
    y_p, dx_p, dk_p, db_p = _torch_conv_grads(x, w, b, g, dtype, conv3d_cuda.conv3d_k3_plain)
    assert type(y.grad_fn).__name__ == "Conv3dK3Backward"
    assert torch.equal(y, y_p)
    _close(dx, dx_p.float().numpy(), dtype)
    _close(dk, dk_p.float().numpy(), dtype)
    if with_bias:
        _close(db, db_p.numpy(), dtype)


def test_conv3d_k3_gradient_reaches_an_fp32_weight_through_the_cast(plain_launchers):
    """The policy's `final` conv keeps an fp32 weight and casts it to the
    compute dtype on every call (models/blocks.py): the cast carries the
    Function's bf16 dk back to it."""
    x, w, b, g = _conv_inputs("bfloat16", True, seed=8)
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    bt = torch.from_numpy(b).requires_grad_()
    conv3d_cuda.Conv3dK3.apply(xt, wt.to(torch.bfloat16), bt).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    assert wt.grad.dtype == torch.float32 and bt.grad.dtype == torch.float32
    _, vjp = jax.vjp(jax_conv3d_k3, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                     jnp.asarray(b))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    _close(wt.grad, want[1], "bfloat16")
    _close(bt.grad, _jax_db(g, "bfloat16"), "float32")


def test_conv3d_k3_vjp_gives_a_contiguous_dx():
    """The VJP hands dx back as a contiguous NDHWC tensor (every operand
    of its one convolution_backward channels-last), and dk in the kernel's
    (3, 3, 3, Cin, Cout) layout and dtype."""
    x = torch.from_numpy(_rand((1, 5, 6, 7, 16), 0)).to(torch.bfloat16)
    w = torch.from_numpy(_rand((3, 3, 3, 16, 8), 1))
    g = torch.from_numpy(_rand((1, 5, 6, 7, 8), 2))
    dx, dk, db = conv3d_cuda.conv3d_k3_vjp(x, w, g)
    assert dx.shape == x.shape and dx.dtype == x.dtype and dx.is_contiguous()
    assert dk.shape == w.shape and dk.dtype == w.dtype
    assert db.shape == (8,) and db.dtype == torch.float32
    assert conv3d_cuda.conv3d_k3_vjp(x, w, g, (False, True, False))[0::2] == (None, None)


def test_conv3d_k3_cuda_branch_is_tracked(monkeypatch):
    """A non-CPU tensor takes the Function: its output carries the
    Function's grad_fn (before, the raw launch returned an untracked
    tensor)."""
    monkeypatch.setattr(conv3d_cuda, "_check", lambda *a: None)
    monkeypatch.setattr(conv3d_cuda, "_launch", conv3d_cuda.conv3d_k3_plain)
    x = torch.empty((1, 4, 4, 4, 8), device="meta", requires_grad=True)
    w = torch.empty((3, 3, 3, 8, 4), device="meta")
    y = conv3d_cuda.conv3d_k3(x, w)
    assert type(y.grad_fn).__name__ == "Conv3dK3Backward"


# -------------------------------------------------------------- corner_lerp
def _lerp_inputs(m, c, seed=0):
    rows = _rand((m, 8 * c), seed)
    w = np.random.default_rng(seed + 1).uniform(0, 1, (8, m)).astype(np.float32)
    g = _rand((m, c), seed + 2)
    return rows, w, g


def _torch_lerp_grads(rows, w, g, dtype, fn):
    rt = torch.from_numpy(rows).to(getattr(torch, dtype)).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fn(rt, wt)
    y.backward(torch.from_numpy(g).to(y.dtype))
    return y, rt.grad, wt.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corner_lerp_backward_matches_jax_vjp(plain_launchers, dtype):
    """Ragged M (the TPU kernel pads to 1024-row blocks), C = 16. d_rows is
    one fp32 product per value, rounded to the rows' dtype in both: equal up
    to that rounding."""
    rows, w, g = _lerp_inputs(1500, 16)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(jax_corner_lerp, jnp.asarray(rows, jdt), jnp.asarray(w))
    want_rows, want_w = vjp(jnp.asarray(g, jdt))
    launches = lerp_cuda.corner_lerp.launches
    _, d_rows, d_w = _torch_lerp_grads(rows, w, g, dtype, lerp_cuda.CornerLerp.apply)
    assert lerp_cuda.corner_lerp.launches == launches
    assert d_rows.dtype == getattr(torch, dtype) and d_w.dtype == torch.float32
    _close(d_rows, want_rows, dtype)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=1e-5 * float(np.abs(want_w).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corner_lerp_function_matches_plain_autograd(plain_launchers, dtype):
    rows, w, g = _lerp_inputs(300, 8, seed=3)
    y, d_rows, d_w = _torch_lerp_grads(rows, w, g, dtype, lerp_cuda.CornerLerp.apply)
    y_p, d_rows_p, d_w_p = _torch_lerp_grads(rows, w, g, dtype, lerp_cuda.corner_lerp_plain)
    assert type(y.grad_fn).__name__ == "CornerLerpBackward"
    assert torch.equal(y, y_p)
    # one fp32 product rounded once on both sides
    assert torch.equal(d_rows, d_rows_p)
    torch.testing.assert_close(d_w, d_w_p, rtol=0, atol=1e-5 * d_w_p.abs().max().item())


def test_corner_lerp_cuda_branch_is_tracked(monkeypatch):
    monkeypatch.setattr(lerp_cuda, "_check", lambda *a: None)
    monkeypatch.setattr(lerp_cuda, "_launch", lerp_cuda.corner_lerp_plain)
    rows = torch.empty((4, 64), device="meta", requires_grad=True)
    y = lerp_cuda.corner_lerp(rows, torch.empty((8, 4), device="meta"))
    assert type(y.grad_fn).__name__ == "CornerLerpBackward"


# --------------------------------------------------------------- refuse_grad
def test_refuse_grad_rule():
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"my_kernel.*my_knob=0"):
        refuse_grad("my_kernel", "my_knob=0", None, torch.zeros(2), t)
    refuse_grad("my_kernel", "my_knob=0", torch.zeros(2), None)   # nothing needs grad
    with torch.no_grad():
        refuse_grad("my_kernel", "my_knob=0", t)
    with torch.inference_mode():
        refuse_grad("my_kernel", "my_knob=0", t)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, device="meta", dtype=dtype, requires_grad=grad)


def _refusing_calls():
    """(module, launcher name, kernel name, knob, call(grad)) for the five
    wrappers without a backward; call(grad) makes its float inputs require
    a gradient when `grad` is true."""
    def packed():
        return {"kernel": {}}
    return [
        (attention_cuda, "_launch", "flash_attention", "use_flash_attention",
         lambda grad: attention_cuda.flash_attention(
             _meta(1, 2, 8, 64, grad=grad), _meta(1, 2, 8, 64), _meta(1, 2, 8, 64))),
        (stats_cuda, "_launch", "spatial_stats_3d", "stats_backend",
         lambda grad: stats_cuda.spatial_stats_3d(_meta(1, 4, 4, 4, 8, grad=grad))),
        (ray_expand_cuda, "_launch", "ray_expand", "mlp_backend",
         lambda grad: ray_expand_cuda.ray_expand(
             _meta(256, 8), _meta(256, 2, grad=grad), (4, 4, 4), (0, 0, 0, 1, 1, 1))),
        (resnetfc_cuda, "_launch", "fused_resnetfc_int8", "mlp_backend",
         lambda grad: resnetfc_cuda.fused_resnetfc_int8(
             _meta(4, 128, dtype=torch.bfloat16, grad=grad), packed())),
        (resnetfc_cuda, "_launch_gather", "fused_gather_resnetfc_int8", "mlp_backend",
         lambda grad: resnetfc_cuda.fused_gather_resnetfc_int8(
             _meta(4, 64, grad=grad), _meta(4, dtype=torch.int32), _meta(8, 4),
             _meta(24, 4, dtype=torch.bfloat16), packed(), d_latent=8)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_kernels_without_backward_refuse_grad(monkeypatch, case):
    module, launcher, name, knob, call = _refusing_calls()[case]
    calls = []
    monkeypatch.setattr(module, launcher, lambda *a, **k: calls.append(a) or "launched")
    with pytest.raises(RuntimeError, match=rf"{name}: .*{knob}"):
        call(True)
    assert calls == []                    # refused before anything ran
    assert call(False) == "launched"      # nothing requires a gradient
    with torch.no_grad():
        assert call(True) == "launched"
    with torch.inference_mode():
        assert call(True) == "launched"
    assert len(calls) == 3


def test_policy_attention_refuses_grad_on_the_kernel_path(monkeypatch):
    """Through MHAttention, q comes from `to_q`, whose weight requires a
    gradient in training: the kernel path raises under grad mode."""
    from real_robot_nerf_actor_tpu_torch.models import perceiver
    monkeypatch.setattr(attention_cuda, "_launch",
                        lambda *a: pytest.fail("launched under grad"))
    attn = perceiver.MHAttention(16, 16, 2, 64, 16, torch.float32, use_flash=True).to("meta")
    with pytest.raises(RuntimeError, match="use_flash_attention"):
        attn(torch.empty((1, 8, 16), device="meta"))


def test_train_step_tool_loads_another_trees_vjp():
    """tools/train_step.py --against DIR takes conv3d_k3_vjp from the
    package under DIR; from this tree it is the same function's arithmetic."""
    import pathlib
    from real_robot_nerf_actor_tpu_torch.tools.train_step import load_vjp
    vjp = load_vjp(pathlib.Path(__file__).resolve().parent.parent)
    assert vjp is not conv3d_cuda.conv3d_k3_vjp
    x = torch.from_numpy(_rand((1, 4, 5, 6, 8), 0))
    w = torch.from_numpy(_rand((3, 3, 3, 8, 4), 1))
    g = torch.from_numpy(_rand((1, 4, 5, 6, 4), 2))
    for a, b in zip(vjp(x, w, g), conv3d_cuda.conv3d_k3_vjp(x, w, g)):
        assert torch.equal(a, b)
