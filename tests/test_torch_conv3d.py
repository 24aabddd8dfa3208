"""k3 conv of the PyTorch port: its plain version (27 tap matmuls, what the
wrapper runs on a CPU tensor) against the JAX Pallas kernel in interpret
mode and the XLA conv, at a volume that is not a multiple of the TPU tiles;
the Hopper kernel is held against the plain version in
test_torch_kernels_cuda.py, on the card.

Tolerances: fp32 1e-4 on outputs of magnitude ~10 (sums of 27*Cin terms in
another order); bf16: one bf16 rounding of the output (2^-8 relative) plus
the bias added before (port) or after (TPU kernel) that rounding, so 2^-7
of the output scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops.conv3d_pallas import (
    _xla_conv3d, conv3d_k3_pallas)
from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import (
    conv3d_k3, conv3d_k3_plain)


def _inputs(shape=(2, 7, 11, 6), cin=12, cout=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b


def _tol(dtype, ref):
    scale = float(np.abs(ref).max())
    return 1e-4 * max(1.0, scale) if dtype == "float32" else scale * 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(dtype):
    x, w, b = _inputs()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_k = np.asarray(conv3d_k3_pallas(jx, jnp.asarray(w), jnp.asarray(b),
                                         interpret=True), np.float32)
    want_x = np.asarray(_xla_conv3d(jx, jnp.asarray(w), jnp.asarray(b)),
                        np.float32)
    launches = conv3d_k3.launches
    got = conv3d_k3(torch.from_numpy(x).to(getattr(torch, dtype)),
                    torch.from_numpy(w), torch.from_numpy(b))
    assert conv3d_k3.launches == launches   # CPU: the plain version
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_k, rtol=0, atol=_tol(dtype, want_k))
    np.testing.assert_allclose(got, want_x, rtol=0, atol=_tol(dtype, want_x))


def test_plain_without_bias_is_zero_padded():
    """A ones kernel on a ones volume counts the in-volume taps: 8 at a
    corner, 27 inside (zero padding, no bias)."""
    x = torch.ones((1, 4, 4, 4, 1))
    out = conv3d_k3_plain(x, torch.ones((3, 3, 3, 1, 1)))
    assert out[0, 0, 0, 0, 0] == 8 and out[0, 1, 1, 1, 0] == 27

