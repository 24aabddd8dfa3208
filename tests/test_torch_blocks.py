"""Blocks of the PyTorch port against the JAX blocks, with the flax
variables converted by real_robot_nerf_actor_tpu_torch.convert: every conv
backend's parameter names (Conv_0 and pallas_kernel/pallas_bias), both
ConvTranspose uses (the k5/s5 upsample and the k3/s2 VALID+crop UNet cell),
BatchNorm statistics, and the UNet encoder.

All parameters (biases and BatchNorm statistics too) are redrawn at random
so that every converted leaf matters. Tolerances: fp32 1e-5 relative to the
output's scale (the same sums in another order); bf16 2^-7 of the scale
(bf16 rounding at different places in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models import blocks as jb
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import blocks as tb


def _randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        return jnp.asarray(rng.standard_normal(a.shape) * 0.3, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _compare(jax_mod, torch_mod, x, dtype="float32", seed=0, **call):
    jx = jnp.asarray(x)
    variables = _randomize(jax_mod.init(jax.random.key(0), jx, **call), seed)
    want = np.asarray(jax_mod.apply(variables, jx, **call), np.float32)
    torch_mod.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    tol = 1e-5 * scale if dtype == "float32" else 2 ** -7 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_block(dtype):
    _compare(jb.DenseBlock(24, "lrelu", dtype=getattr(jnp, dtype)),
             tb.DenseBlock(16, 24, "lrelu", dtype=getattr(torch, dtype)),
             _x((3, 16)), dtype)


@pytest.mark.parametrize("backend", ["xla", "conv2d", "conv2d_packed", "pallas"])
@pytest.mark.parametrize("padding", ["zeros", "replicate"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_block(backend, padding, dtype):
    jm = jb.Conv3DBlock(10, 3, 1, "lrelu", dtype=getattr(jnp, dtype),
                        padding=padding, backend=backend)
    tm = tb.Conv3DBlock(6, 10, 3, 1, "lrelu", dtype=getattr(torch, dtype),
                        padding=padding, backend=backend)
    assert tm.use_kernel == (backend == "pallas" and padding == "zeros")
    _compare(jm, tm, _x((1, 6, 7, 5, 6)), dtype)


@pytest.mark.parametrize("kernel_size,stride", [(1, 1), (5, 1), (3, 2)])
def test_conv3d_block_other_shapes(kernel_size, stride):
    _compare(jb.Conv3DBlock(8, kernel_size, stride, "relu"),
             tb.Conv3DBlock(4, 8, kernel_size, stride, "relu"),
             _x((2, 6, 6, 6, 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patchify(dtype):
    _compare(jb.PatchifyConv3D(12, 5, "lrelu", dtype=getattr(jnp, dtype)),
             tb.PatchifyConv3D(3, 12, 5, "lrelu", dtype=getattr(torch, dtype)),
             _x((1, 10, 10, 15, 3)), dtype)


@pytest.mark.parametrize("mode", ["transpose", "subpixel", "trilinear"])
def test_upsample_block(mode):
    """transpose is the policy's up0: k5 replicate conv, then the k5/s5
    ConvTranspose whose kernel convert.py flips."""
    _compare(jb.Conv3DUpsampleBlock(6, 5, 5, "lrelu", mode=mode),
             tb.Conv3DUpsampleBlock(8, 6, 5, 5, "lrelu", mode=mode),
             _x((1, 3, 2, 3, 8)))


def test_upsample_block_bf16():
    _compare(jb.Conv3DUpsampleBlock(6, 5, 5, "lrelu", dtype=jnp.bfloat16,
                                    mode="transpose"),
             tb.Conv3DUpsampleBlock(8, 6, 5, 5, "lrelu", dtype=torch.bfloat16,
                                    mode="transpose"),
             _x((1, 2, 2, 2, 8)), "bfloat16")


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu(stride):
    _compare(jb.ConvBnReLU3D(8, stride=stride), tb.ConvBnReLU3D(5, 8, stride),
             _x((1, 7, 6, 5, 5)), train=False)


@pytest.mark.parametrize("in_size,out_size", [(4, 7), (4, 8), (13, 25)])
def test_deconv_bn(in_size, out_size):
    """The k3/s2 VALID transpose + crop, both output parities."""
    tm = tb.DeconvBn3D(6, 4)
    jm = jb.DeconvBn3D(4, out_size)
    x = _x((1, in_size, in_size, in_size, 6))
    variables = _randomize(jm.init(jax.random.key(0), jnp.asarray(x), train=False))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), out_size).numpy()
    assert got.shape == want.shape == (1, out_size, out_size, out_size, 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_unet_encoder():
    _compare(jb.MultiLayer3DEncoderShallow(8), tb.MultiLayer3DEncoderShallow(10, 8),
             _x((1, 20, 20, 20, 10)), train=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contract_first_conv(dtype):
    _compare(jb.ContractFirstConv3D(1, 3, None, dtype=getattr(jnp, dtype)),
             tb.ContractFirstConv3D(8, 1, 3, None, dtype=getattr(torch, dtype)),
             _x((1, 6, 5, 7, 8)), dtype)


def test_init_weights_draws_like_flax():
    """Seeded init: reproducible, biases zero, He-uniform bound respected."""
    def make(seed):
        return tb.init_weights(tb.Conv3DBlock(6, 10, 3, 1, "lrelu",
                                              padding="zeros", backend="pallas"),
                               torch.Generator().manual_seed(seed))
    a, b = make(0), make(0)
    torch.testing.assert_close(a.pallas_kernel, b.pallas_kernel)
    assert not torch.equal(a.pallas_kernel, make(1).pallas_kernel)
    bound = (3 * 2.0 / (1 + 0.02 ** 2) / (27 * 6)) ** 0.5
    assert a.pallas_kernel.abs().max() <= bound
    assert a.pallas_kernel.abs().max() > 0.8 * bound
    assert torch.count_nonzero(a.pallas_bias) == 0
