"""BatchNorm of the PyTorch port in train mode against flax's
`nn.BatchNorm(use_running_average=False, momentum=0.9)` applied with
`mutable=["batch_stats"]`: the bare BatchNorm, the two UNet cells and the
whole `MultiLayer3DEncoderShallow`, with the flax variables (parameters and
running statistics redrawn at random) converted into the torch module. Held:
the output, the updated running mean and variance, and the gradients of a
fixed linear functional of the output with respect to the input and every
parameter. Then the eval mode (the default, `train=False`) on the updated
statistics, which must leave them as they are.

Tolerances (fp32): outputs and statistics 1e-5 of their scale (the same
sums in another order); gradients 1e-4 of each tensor's largest |g|, as
the train-step tests hold them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from real_robot_nerf_actor_tpu.models import blocks as jb
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import blocks as tb


class _JaxBN(nn.Module):
    """flax BatchNorm with the JAX package's settings, train flag as its
    cells take it."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        return nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)


class _TorchBN(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.BatchNorm_0 = tb.BatchNorm(c)

    def forward(self, x, train=False):
        return self.BatchNorm_0(x, train)


def _randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        return jnp.asarray(rng.standard_normal(a.shape) * 0.3, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


CASES = {
    # (jax module, torch module, input shape, extra positional args of both)
    "batchnorm": (lambda: _JaxBN(), lambda: _TorchBN(6), (2, 5, 4, 3, 6), ()),
    "conv_bn_relu": (lambda: jb.ConvBnReLU3D(8, stride=2),
                     lambda: tb.ConvBnReLU3D(5, 8, 2), (2, 7, 6, 5, 5), ()),
    "deconv_bn": (lambda: jb.DeconvBn3D(4, 7), lambda: tb.DeconvBn3D(6, 4),
                  (1, 4, 4, 4, 6), (7,)),
    "unet": (lambda: jb.MultiLayer3DEncoderShallow(8),
             lambda: tb.MultiLayer3DEncoderShallow(10, 8), (2, 12, 12, 12, 10), ()),
}


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_train_mode_matches_flax(case):
    make_j, make_t, shape, extra = CASES[case]
    jm, tm = make_j(), make_t()
    rng = np.random.default_rng(1)
    # off-centre inputs, so that the variance is not E[x^2] alone
    x = (rng.standard_normal(shape) * 1.7 + 0.6).astype(np.float32)
    variables = _randomize(jm.init(jax.random.key(0), jnp.asarray(x), train=False))
    out_shape = jax.eval_shape(lambda: jm.apply(variables, jnp.asarray(x), train=False))
    cot = rng.standard_normal(out_shape.shape).astype(np.float32)

    def loss(params, xx):
        y, new = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, new["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    tm.load_state_dict(flax_to_state_dict(variables))
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt, *extra, train=True)
    (y * torch.from_numpy(cot)).sum().backward()

    _close(y, want_y, 1e-5, "output")
    sd = tm.state_dict()
    want_sd = flax_to_state_dict({"batch_stats": want_stats})
    assert want_sd and set(want_sd) <= set(sd)
    for k, w in want_sd.items():
        _close(sd[k], w.numpy(), 1e-5, k)
    _close(xt.grad, want_gx, 1e-4, "d input")
    want_g = flax_to_state_dict({"params": want_gp})
    named = dict(tm.named_parameters())
    assert set(want_g) == set(named)
    for k, w in want_g.items():
        _close(named[k].grad, w.numpy(), 1e-4, f"d {k}")

    # eval mode on the updated statistics, which it leaves as they are
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    want_eval = jm.apply({"params": variables["params"], "batch_stats": want_stats},
                         jnp.asarray(x), train=False)
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x), *extra)
    _close(got_eval, want_eval, 1e-5, "eval output")
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


def test_train_mode_bf16_input_keeps_fp32_statistics():
    """A bf16 input is normalised with fp32 statistics (flax promotes the
    reduction to fp32): the running mean equals the fp32 input's update."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((2, 4, 4, 4, 6)) + 0.5).astype(np.float32))
    xb = x.to(torch.bfloat16)
    a, b = tb.BatchNorm(6), tb.BatchNorm(6)
    ya = a(xb, train=True)
    b(xb.float(), train=True)
    assert ya.dtype == torch.float32
    torch.testing.assert_close(a.running_mean, b.running_mean, rtol=0, atol=0)
    torch.testing.assert_close(a.running_var, b.running_var, rtol=0, atol=0)
