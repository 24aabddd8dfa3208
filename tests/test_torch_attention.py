"""Flash attention of the PyTorch port: its plain version (what the wrapper
runs on a CPU tensor) against the JAX Pallas kernel in interpret mode and
against JAX's reference_attention. The Hopper kernel itself is held
against the plain version in test_torch_kernels_cuda.py, on the card.

Tolerances: fp32 1e-5 absolute (the same sums in another order, outputs
below 2); bf16 2^-6 of the largest output, i.e. two bf16 ulps of it: the
output is rounded to bf16, where two near-equal fp32 values can land one
ulp apart, and the probabilities are rounded to bf16 before P.V at other
points of the online softmax in the two kernels (JAX's reference also
rounds the scores). With standard-normal q, k, v the outputs shrink as
Nk grows (std ~ sqrt(e / Nk)), so a fixed absolute bf16 tolerance would be
loose at the policy's 8077 keys; `test_bf16_tolerance_sees_a_dropped_kv_tail`
shows that this one rejects a kernel that skips the ragged last kv tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops.attention_pallas import (
    flash_attention as jax_flash, reference_attention as jax_reference)
from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import (
    flash_attention, flash_attention_plain, reference_attention)



def _tol(dtype, want):
    """fp32: 1e-5 absolute; bf16: 2^-6 of the largest |output|."""
    return 1e-5 if dtype == "float32" else 2 ** -6 * float(np.abs(want).max())


def _qkv(heads, nq, nk, seed=0, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, heads, nq, d)).astype(np.float32),
            rng.standard_normal((1, heads, nk, d)).astype(np.float32),
            rng.standard_normal((1, heads, nk, d)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,nq,nk", [(1, 77, 125), (2, 40, 202)])
def test_plain_matches_jax_kernel(dtype, heads, nq, nk):
    q, k, v = _qkv(heads, nq, nk)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                block_q=32, block_k=128, interpret=True),
                      np.float32)
    launches = flash_attention.launches
    got = flash_attention(*(_torch(a, dtype) for a in (q, k, v)))
    assert flash_attention.launches == launches   # CPU: the plain version
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))
    ref = np.asarray(jax_reference(*(jnp.asarray(a, jdt) for a in (q, k, v))),
                     np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(dtype, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_attention_matches_jax(dtype):
    q, k, v = _qkv(2, 33, 70, seed=1)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_reference(*(jnp.asarray(a, jdt) for a in (q, k, v))),
                      np.float32)
    got = reference_attention(*(_torch(a, dtype) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))


def test_plain_scale_and_masking():
    """sm_scale is honoured, and one key makes the output that key's value."""
    q, k, v = _qkv(1, 5, 1, seed=2)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(v, got.shape),
                               rtol=1e-6)


def test_bf16_tolerance_sees_a_dropped_kv_tail():
    """At the cross-attend shape (2048 queries, 8077 = 126 * 64 + 13 keys)
    a kernel that skipped the last, partial kv tile would miss the bf16
    tolerance: dropping keys 8064..8076 moves the output by more than it."""
    q, k, v = (_torch(a, "bfloat16") for a in _qkv(1, 2048, 8077, seed=3))
    want = flash_attention_plain(q, k, v).float().numpy()
    dropped = flash_attention_plain(q, k[:, :, :8064], v[:, :, :8064])
    assert np.abs(dropped.float().numpy() - want).max() > 2 * _tol("bfloat16", want)
