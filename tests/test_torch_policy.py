"""PerceiverIO of the PyTorch port against the JAX PerceiverIO, with the
flax variables converted by real_robot_nerf_actor_tpu_torch.convert.

A tiny width with V=20 and patch 5: the stats gate (cubic, V % 4 == 0)
holds for d0 (20^3) and dec (4^3), and the flash / pallas-conv parameter
names are exercised. JAX's Pallas kernels run in interpret mode here; the
port's kernel wrappers run their plain versions (CPU tensors).

Tolerances, relative to each output's largest magnitude: fp32 1e-4 (sums
of a few thousand terms in another order); bf16 1e-1: the two frameworks
round bf16 at different places, and the plain spatial-softmax path
subtracts the max in bf16 and divides by T = 0.01, which turns a one-ulp
difference of a d0 feature into a change of up to ~e^0.4 in its weight
(measured worst case 0.072 on the rot/grip logits of scale 0.7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxConfig
from real_robot_nerf_actor_tpu.models import PerceiverIO as JaxPerceiverIO
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig, PerceiverIO

TINY = dict(depth=1, voxel_size=20, num_latents=16, latent_dim=32,
            im_channels=8, cross_dim_head=64, latent_dim_head=64,
            latent_heads=2, voxel_patch_size=5, final_dim=8, lang_emb_dim=16,
            lang_max_seq_len=4, aux_trans_head=True, return_voxel_feat=True,
            grip_proprio_scale=25.0)
KNOBS_ON = dict(use_flash_attention=True, conv_backend="pallas",
                stats_backend="pallas")
KNOBS_OFF = dict(use_flash_attention=False, conv_backend="conv2d",
                 stats_backend="xla")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    vox = rng.uniform(-1, 1, (1, 20, 20, 20, 10)).astype(np.float32)
    proprio = np.array([[12, 3, 7, 35, 2, 70, 1]], np.float32)
    lang = rng.standard_normal((1, 4, 16)).astype(np.float32)
    return vox, proprio, lang


def _run_both(kw):
    jcfg = JaxConfig(**kw)
    net = JaxPerceiverIO(jcfg)
    vox, proprio, lang = _inputs()
    with pltpu.force_tpu_interpret_mode():
        variables = net.init(jax.random.key(1), jnp.asarray(vox),
                             jnp.asarray(proprio), jnp.asarray(lang))
    # non-trivial BatchNorm statistics, so the converted buffers matter
    if "batch_stats" in variables:
        rng = np.random.default_rng(2)
        variables = dict(variables)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            variables["batch_stats"])
    with pltpu.force_tpu_interpret_mode():
        want = net.apply(variables, jnp.asarray(vox), jnp.asarray(proprio),
                         jnp.asarray(lang))
    tnet = PerceiverIO(PerceiverConfig(**kw))
    tnet.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = tnet(torch.from_numpy(vox), torch.from_numpy(proprio),
                   torch.from_numpy(lang))
    return [np.asarray(w, np.float32) for w in want], \
        [g.float().numpy() for g in got]


def _assert_close(want, got, rel):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def _assert_argmax_agrees(want, got, tol):
    """argmax only where the top-2 margin exceeds the tolerance: borderline
    ties may flip between backends (BENCH_NOTES.md, conv2d note)."""
    for w, g in zip(want, got):
        flat_w, flat_g = w.reshape(w.shape[0], -1), g.reshape(g.shape[0], -1)
        top2 = np.sort(flat_w, axis=-1)[:, -2:]
        ok = (top2[:, 1] - top2[:, 0]) > 2 * tol
        assert (flat_w.argmax(-1) == flat_g.argmax(-1))[ok].all()


@pytest.mark.parametrize("encoder", ["unet", "conv1"])
@pytest.mark.parametrize("knobs", ["on", "off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_policy_matches_jax(encoder, knobs, dtype):
    kw = dict(TINY, input_encoder=encoder, compute_dtype=dtype,
              **(KNOBS_ON if knobs == "on" else KNOBS_OFF))
    want, got = _run_both(kw)
    rel = 1e-4 if dtype == "float32" else 1e-1
    _assert_close(want, got, rel)
    scale = max(1.0, float(np.abs(want[0]).max()))
    _assert_argmax_agrees(want[:3], got[:3], rel * scale)


def test_param_names_cover_both_trees():
    """The converted flax tree fills every parameter and buffer of the port's
    module, for both encoders and both conv backends, and nothing is left."""
    for encoder in ("unet", "conv1"):
        for knobs in (KNOBS_ON, KNOBS_OFF):
            kw = dict(TINY, input_encoder=encoder, **knobs)
            with pltpu.force_tpu_interpret_mode():
                variables = JaxPerceiverIO(JaxConfig(**kw)).init(
                    jax.random.key(0), *map(jnp.asarray, _inputs()))
            sd = flax_to_state_dict(variables)
            want = PerceiverIO(PerceiverConfig(**kw)).state_dict()
            assert set(sd) == set(want)
            for k, v in sd.items():
                assert tuple(v.shape) == tuple(want[k].shape), k
