"""The PerAct BC train step of the PyTorch port against the JAX package's,
at the tiny size of tests/test_train.py (depth 1, V 10, 32 x 64 latents,
2000 points): the SE(3) augmentation, the one-hot targets, `bc_losses`
and the whole `train_step`, on inputs made from a numpy seed, with the
SE(3) draws made by the JAX key as `train/peract.py` splits it and fed to
the port through `draws=` / `u=`. Weights are drawn with numpy into the
flax tree and converted (convert.flax_to_state_dict). The JAX step's
gradients come out through an optax transform that keeps them as its
state. On the CPU the port's `pallas` conv runs its plain version and
JAX's `conv3d_k3` the XLA conv.

Tolerances: fp32 losses 1e-5 relative and gradients 1e-4 of each tensor's
largest |g| (sums in another order). bf16 see `_TOL`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxPerceiverConfig
from real_robot_nerf_actor_tpu.ops import VoxelizerSpec as JaxSpec
from real_robot_nerf_actor_tpu.ops.action_codec import DiscreteAction as JaxAction
from real_robot_nerf_actor_tpu.ops.action_codec import one_hot_expert_actions as jax_one_hot
from real_robot_nerf_actor_tpu.ops.se3_aug import apply_se3_augmentation as jax_aug
from real_robot_nerf_actor_tpu.train.peract import PerActConfig as JaxCfg
from real_robot_nerf_actor_tpu.train.peract import PerActTrainer as JaxTrainer
from real_robot_nerf_actor_tpu.train.peract import bc_losses as jax_bc_losses
from real_robot_nerf_actor_tpu.train.trainer import TrainState as JaxState
from real_robot_nerf_actor_tpu.train.trainer import make_optimizer
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    make_synthetic_demo, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec, discretize_action
from real_robot_nerf_actor_tpu_torch.ops.action_codec import (
    DiscreteAction, one_hot_expert_actions)
from real_robot_nerf_actor_tpu_torch.ops.se3_aug import apply_se3_augmentation
from real_robot_nerf_actor_tpu_torch.train.peract import (
    PerActConfig, PerActTrainer, bc_losses)

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
TINY = dict(depth=1, voxel_size=10, num_latents=32, latent_dim=64, im_channels=8,
            cross_dim_head=16, latent_dim_head=16, latent_heads=2, voxel_patch_size=5,
            final_dim=8, lang_emb_dim=16, lang_max_seq_len=4, num_rotation_classes=72)
N_POINTS = 2000
B = 2


def _configs(**kw):
    """The tiny PerActConfig of both packages."""
    top = {k: kw.pop(k) for k in ("use_se3_aug",) if k in kw}
    jax_cfg = JaxCfg(model=JaxPerceiverConfig(**TINY, **kw),
                     voxelizer=JaxSpec(voxel_size=10, max_num_coords=N_POINTS),
                     coord_bounds=BOUNDS, **top)
    cfg = PerActConfig(model=PerceiverConfig(**TINY, **kw),
                       voxelizer=VoxelizerSpec(voxel_size=10, max_num_coords=N_POINTS),
                       coord_bounds=BOUNDS, **top)
    return jax_cfg, cfg


# ------------------------------------------------------------ SE(3) aug
def _keyframes(rng, n):
    """Pairs of keyframes: inside the bounds, and on or next to them (a
    keyframe on the low bound, one a hair under the high bound)."""
    lo, hi = np.array(BOUNDS[:3]), np.array(BOUNDS[3:])
    kf = rng.uniform(lo, hi, (n, 2, 3))
    kf[0, 0] = lo
    kf[1, 1] = hi - 1e-7
    kf[2, :, 0] = lo[0]
    kf[3, 1, 2] = hi[2] - 0.004
    return kf.astype(np.float32)


@pytest.mark.parametrize("symmetric", [True, False])
def test_se3_augmentation_matches_jax(symmetric):
    """One shift for the whole cloud (the JAX signature), per keyframe pair,
    for both clamp modes: the same shift and cloud, the same voxel indices."""
    rng = np.random.default_rng(0)
    pcd = rng.uniform(-0.2, 0.8, (1, 300, 3)).astype(np.float32)
    bounds = np.array(BOUNDS, np.float32)
    ranges = np.array([0.125, 0.05, 0.05], np.float32)
    kfs = _keyframes(rng, 24)
    for i, kf in enumerate(kfs):
        key = jax.random.key(i)
        want = jax_aug(key, jnp.asarray(pcd), jnp.asarray(kf), jnp.asarray(bounds),
                       jnp.asarray(ranges), 10, symmetric_clamp=symmetric)
        u = np.array(jax.random.uniform(key, (3,), minval=-1.0, maxval=1.0))
        got = apply_se3_augmentation(torch.from_numpy(pcd), torch.from_numpy(kf),
                                     torch.from_numpy(bounds), torch.from_numpy(ranges),
                                     10, symmetric_clamp=symmetric, u=torch.from_numpy(u))
        np.testing.assert_array_equal(got.action_trans.numpy(), np.asarray(want.action_trans))
        np.testing.assert_allclose(got.shift.numpy(), np.asarray(want.shift), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(got.pcd.numpy(), np.asarray(want.pcd), rtol=0, atol=1e-6)
        assert (got.action_trans.numpy() >= 0).all() and (got.action_trans.numpy() < 10).all()


def test_se3_augmentation_batched_matches_jax_vmap():
    """(B, K, 3) keyframes with (B, 3) draws: each cloud its own shift, as
    the JAX step's vmap gives it; the draws from a generator when absent."""
    rng = np.random.default_rng(1)
    pcd = rng.uniform(-0.2, 0.8, (6, 200, 3)).astype(np.float32)
    kf = _keyframes(rng, 6)
    bounds = jnp.asarray(BOUNDS)
    ranges = jnp.asarray([0.125, 0.05, 0.05])
    keys = jax.random.split(jax.random.key(3), 6)
    want = jax.vmap(lambda k, p, x: jax_aug(k, p[None], x, bounds, ranges, 10))(
        keys, jnp.asarray(pcd), jnp.asarray(kf))
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0,
                                                         maxval=1.0))(keys))
    args = (torch.from_numpy(pcd), torch.from_numpy(kf),
            torch.tensor(BOUNDS, dtype=torch.float32),
            torch.tensor([0.125, 0.05, 0.05]), 10)
    got = apply_se3_augmentation(*args, u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.action_trans.numpy(), np.asarray(want.action_trans))
    np.testing.assert_allclose(got.pcd.numpy(), np.asarray(want.pcd)[:, 0], rtol=0, atol=1e-6)
    drawn = apply_se3_augmentation(*args, generator=torch.Generator().manual_seed(0))
    again = apply_se3_augmentation(*args, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn.shift, again.shift) and drawn.shift.shape == (6, 3)
    assert (drawn.action_trans >= 0).all() and (drawn.action_trans < 10).all()


# --------------------------------------------------------- targets, losses
def _actions(rng, b, v=10, r=72):
    trans = rng.integers(0, v, (b, 3)).astype(np.int32)
    trans[0] = [0, v - 1, 0]                  # on the grid's edge
    rot_grip = np.concatenate([rng.integers(-1, r, (b, 3)), rng.integers(0, 2, (b, 1))],
                              1).astype(np.int32)
    rot_grip[1, 0] = -1                       # the codec's bin below 0
    coll = rng.integers(0, 2, (b, 1)).astype(np.int32)
    return trans, rot_grip, coll


def test_one_hot_expert_actions_matches_jax():
    trans, rot_grip, coll = _actions(np.random.default_rng(2), 5)
    want = jax_one_hot(JaxAction(jnp.asarray(trans), jnp.asarray(rot_grip),
                                 jnp.asarray(coll)), 10)
    got = one_hot_expert_actions(DiscreteAction(torch.from_numpy(trans),
                                                torch.from_numpy(rot_grip),
                                                torch.from_numpy(coll)), 10)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("variant", ["plain", "trans_smooth", "z_loss", "aux"])
def test_bc_losses_match_jax(variant):
    """The loss, each metric and the logits' gradients, fp32."""
    rng = np.random.default_rng(3)
    b, v, r = 3, 10, 72
    trans, rot_grip, coll = _actions(rng, b)
    q_trans = (rng.standard_normal((b, v, v, v)) * 3).astype(np.float32)
    q_rg = (rng.standard_normal((b, 3 * r + 2)) * 3).astype(np.float32)
    q_coll = rng.standard_normal((b, 2)).astype(np.float32)
    q_aux = rng.standard_normal((b, 8)).astype(np.float32)
    kw = {"plain": {}, "trans_smooth": {"trans_smooth": 0.2},
          "z_loss": {"z_loss": 1e-2}, "aux": {"lambda_aux": 0.5}}[variant]

    def jax_loss(qt, qrg, qc, qa):
        return jax_bc_losses(qt, qrg, qc, JaxAction(jnp.asarray(trans), jnp.asarray(rot_grip),
                                                    jnp.asarray(coll)), v, r,
                             q_trans_aux=qa if variant == "aux" else None, **kw)

    (want, want_m), want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (q_trans, q_rg, q_coll, q_aux)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q_trans, q_rg, q_coll, q_aux)]
    got, got_m = bc_losses(ts[0], ts[1], ts[2],
                           DiscreteAction(*map(torch.from_numpy, (trans, rot_grip, coll))),
                           v, r, q_trans_aux=ts[3] if variant == "aux" else None, **kw)
    got.backward()
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5)
    for t, w in zip(ts, want_g):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * max(scale, 1e-30))


# -------------------------------------------------------------- train step
def _batch(seed=4):
    """Two samples from the synthetic scene: 2000 random points of the
    cloud (the last 100 padding), a keyframe pair of the demo each."""
    rng = np.random.default_rng(seed)
    scene = make_synthetic_scene(seed=0)
    demo = make_synthetic_demo(scene)
    bounds = torch.tensor(BOUNDS)
    disc = discretize_action(torch.from_numpy(demo.xyz), torch.from_numpy(demo.rotation),
                             torch.from_numpy(demo.gripper_open),
                             torch.ones(demo.num_keyframes), bounds, 10)
    out = {k: [] for k in ("points", "colors", "valid", "proprio", "lang", "kf_xyz",
                           "rot_grip", "collision")}
    for i in (0, 2):
        pick = rng.choice(scene.points.shape[0], N_POINTS, replace=False)
        valid = np.ones(N_POINTS, bool)
        valid[-100:] = False
        out["points"].append(np.where(valid[:, None], scene.points[pick], 0.0))
        out["colors"].append(np.where(valid[:, None], scene.colors[pick], 0.0))
        out["valid"].append(valid)
        out["proprio"].append(np.concatenate([np.zeros(3), disc.rot_grip[i].numpy()]))
        out["lang"].append(rng.standard_normal((4, 16)))
        out["kf_xyz"].append(demo.xyz[i:i + 2])
        out["rot_grip"].append(disc.rot_grip[i + 1].numpy())
        out["collision"].append(disc.collision[i + 1].numpy())
    batch = {k: np.stack(v) for k, v in out.items()}
    for k in ("points", "colors", "proprio", "lang", "kf_xyz"):
        batch[k] = batch[k].astype(np.float32)
    return batch


def _numpy_params(shapes, seed=5):
    """A flax params tree of `shapes` drawn with numpy: kernels N(0, 1 /
    fan_in), biases N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2), the
    positional encoding and the latents N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("pos_encoding", "latents"):
            a = rng.standard_normal(s.shape)
        elif len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _keep_grads():
    """An optax transform whose update is zero and whose state is the
    gradient it was given."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _numpy_batch_stats(shapes, seed=6):
    """BatchNorm running statistics drawn with numpy: means N(0, 0.3^2),
    variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, s.shape), jnp.float32)
        return jnp.asarray(0.3 * rng.standard_normal(s.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_step(jax_cfg, batch):
    """JAX train_step on `batch` at key 1: (loss metrics, params, grads,
    the SE(3) draws of its key, the batch statistics before and after the
    step; {} without BatchNorm)."""
    tr = JaxTrainer(jax_cfg)
    tr.tx = _keep_grads()
    m = jax_cfg.model
    shapes = jax.eval_shape(lambda: tr.net.init(
        jax.random.key(0), jnp.zeros((1, 10, 10, 10, 10)), jnp.zeros((1, 7)),
        jnp.zeros((1, m.lang_max_seq_len, m.lang_emb_dim))))
    params = _numpy_params(shapes["params"])
    extra = ({"batch_stats": _numpy_batch_stats(shapes["batch_stats"])}
             if "batch_stats" in shapes else {})
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=tr.tx.init(params), extra=extra)
    rng = jax.random.key(1)
    new, metrics = jax.jit(tr.train_step)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                          rng)
    k_aug, _ = jax.random.split(rng)
    draws = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))(
        jax.random.split(k_aug, B))
    return ({k: float(v) for k, v in metrics.items()}, params, new.opt_state,
            np.array(draws), extra, new.extra)


@pytest.fixture(scope="module")
def steps():
    """(dtype, conv, aug) -> both packages' step from the same weights,
    batch and draws: (JAX metrics, params, grads; the port's metrics,
    grads, and parameters after its AdamW step), each computed once."""
    cache = {}

    def get(dtype, conv, aug=True, encoder="conv1"):
        key = (dtype, conv, aug, encoder)
        if key not in cache:
            jax_cfg, cfg = _configs(compute_dtype=dtype, conv_backend=conv, use_se3_aug=aug,
                                    input_encoder=encoder)
            batch = _batch()
            jax_m, params, grads, draws, stats, new_stats = _jax_step(jax_cfg, batch)
            tr = PerActTrainer(cfg, device="cpu")
            state = tr.init_state(torch.Generator().manual_seed(0))
            state.module.load_state_dict(flax_to_state_dict({"params": params, **stats}))
            state, got_m = tr.train_step(state, {k: torch.from_numpy(v) for k, v in
                                                 batch.items()},
                                         draws=torch.from_numpy(draws))
            assert state.step == 1
            named = dict(state.module.named_parameters())
            cache[key] = dict(
                jax_m=jax_m, params=params, grads=grads,
                jax_g=flax_to_state_dict({"params": grads}),
                m={k: v.item() for k, v in got_m.items()},
                g={n: p.grad.clone() for n, p in named.items()},
                p={n: p.detach().clone() for n, p in named.items()},
                stats=dict(state.module.named_buffers()),
                jax_stats=flax_to_state_dict(new_stats),
                optim=jax_cfg.train.optim)
        return cache[key]
    return get


# the trans decoder's bias shifts all V^3 trans logits alike, which the
# softmax CE does not see: its gradient is zero, and what either package
# computes is the rounding of a sum of V^3 B terms
INVARIANT = "trans_decoder.bias"


@pytest.mark.parametrize("conv,aug", [("conv2d", True), ("pallas", True),
                                      ("conv2d", False)])
def test_train_step_matches_jax(steps, conv, aug):
    """fp32, one step from the same weights, batch and SE(3) draws: the
    loss and every metric within 1e-5 relative, every parameter's gradient
    within 1e-4 of the tensor's largest |g|. Then the parameters after the
    port's AdamW step against optax's update on the JAX gradients: at step
    1 an update is lr * g / (|g| + 1e-8), so an entry whose gradient lies
    within the gradients' tolerance of zero may move by anything up to
    2 lr apart (27-33 of the 189045 entries here, each with |g| under 5e-5
    of its tensor's largest); every other entry agrees to 1e-3 lr plus
    fp32 rounding."""
    _check_fp32_step(steps("float32", conv, aug), conv)


def _check_fp32_step(r, conv):
    assert set(r["m"]) == set(r["jax_m"])
    for k, w in r["jax_m"].items():
        np.testing.assert_allclose(r["m"][k], w, rtol=1e-5, err_msg=k)
    assert set(r["g"]) == set(r["jax_g"])
    assert r["g"]["final.pallas_kernel" if conv == "pallas" else "final.Conv_0.weight"] \
        .abs().max() > 0
    top = max(w.abs().max().item() for w in r["jax_g"].values())
    for n, w in r["jax_g"].items():
        if n == INVARIANT:
            assert max(w.abs().max().item(), r["g"][n].abs().max().item()) <= 1e-5 * top
            continue
        torch.testing.assert_close(r["g"][n], w, rtol=0, atol=1e-4 * w.abs().max().item(),
                                   msg=lambda m: f"{n}: {m}")

    tx = make_optimizer(r["optim"])
    upd, _ = tx.update(r["grads"], tx.init(r["params"]), r["params"])
    want_p = flax_to_state_dict({"params": optax.apply_updates(r["params"], upd)})
    lr = r["optim"].lr
    moved = 0
    for n, w in want_p.items():
        gap = (r["p"][n] - w).abs()
        assert (gap <= 2 * lr * (1 + 1e-3) + 1e-6 * w.abs()).all(), n
        apart = gap > 1e-3 * lr + 1e-6 * w.abs()
        if n != INVARIANT and apart.any():
            g = r["jax_g"][n].abs()
            assert (g[apart] <= 1e-4 * g.max()).all(), n
            moved += int(apart.sum())
    assert moved <= 1e-3 * sum(w.numel() for w in want_p.values()), moved


def _rel(a, b):
    return ((a - b).norm() / max(b.norm().item(), 1e-30)).item()


@pytest.mark.parametrize("conv", ["conv2d", "pallas"])
def test_train_step_bf16_within_jax_bf16_error(steps, conv):
    """bf16 (compute_dtype bfloat16): the two packages round bf16 at other
    places (JAX also sums some reductions in bf16), and a one-ulp change of
    a d0 feature moves its spatial-softmax weight by up to e^0.4 at the
    temperature 0.01, so their bf16 gradients differ from the fp32 step by
    20-130% of a tensor's norm at this tiny size, and from each other by as
    much. The check: each package's bf16 step against the JAX fp32 step,
    the port no further from it than 3x the JAX package's own bf16 step
    (the worst ratio measured is 2.0), plus 2^-8 of the metric or of the
    tensor's norm."""
    _check_bf16_step(steps("float32", conv), steps("bfloat16", conv))


def _check_bf16_step(ref, r):
    for k, w in ref["jax_m"].items():
        jax_err, err = abs(r["jax_m"][k] - w), abs(r["m"][k] - w)
        assert err <= 3 * jax_err + 2 ** -8 * abs(w), (k, err, jax_err)
    for n, w in ref["jax_g"].items():
        if n == INVARIANT:
            continue
        jax_err, err = _rel(r["jax_g"][n], w), _rel(r["g"][n], w)
        assert err <= 3 * jax_err + 2 ** -8, (n, err, jax_err)


def test_synthetic_data_matches_jax():
    """The port's synthetic batches are the JAX package's: the same numpy
    draws, the same padded clouds, discrete targets and language tokens."""
    jax_cfg, cfg = _configs()
    want = next(JaxTrainer(jax_cfg).synthetic_data(batch_size=3, seed=2))
    got = next(PerActTrainer(cfg, device="cpu").synthetic_data(batch_size=3, seed=2))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_unet_matches_jax(steps, dtype):
    """input_encoder "unet": the step runs the encoder's BatchNorm on batch
    statistics, as the JAX step does under mutable=["batch_stats"]. fp32:
    the bounds of test_train_step_matches_jax, and the running statistics
    after the step within 1e-5 of their scale; bf16: the bounds of
    test_train_step_bf16_within_jax_bf16_error (the encoder runs in fp32 in
    both packages), the statistics within 1e-5 of the fp32 JAX step's."""
    r = steps(dtype, "conv2d", encoder="unet")
    ref = steps("float32", "conv2d", encoder="unet")
    if dtype == "float32":
        _check_fp32_step(r, "conv2d")
    else:
        _check_bf16_step(ref, r)
    assert r["jax_stats"] and set(r["jax_stats"]) == set(r["stats"])
    for n, w in ref["jax_stats"].items():
        torch.testing.assert_close(r["stats"][n], w, rtol=0,
                                   atol=1e-5 * w.abs().max().item(), msg=lambda m: f"{n}: {m}")


def test_config_dataclass_matches_jax():
    """PerActConfig keeps the JAX package's fields and defaults."""
    from real_robot_nerf_actor_tpu.utils.config import to_dict as jax_to_dict
    from real_robot_nerf_actor_tpu_torch.utils.config import to_dict
    assert to_dict(PerActConfig()) == jax_to_dict(JaxCfg())
    assert [f.name for f in dataclasses.fields(PerActConfig)] == \
        [f.name for f in dataclasses.fields(JaxCfg)]


@pytest.mark.parametrize("mode", ["uniform", "demo_cycle"])
def test_iter_transitions_matches_jax(mode):
    """The same (demo, keyframe) picks from the same numpy generator."""
    from real_robot_nerf_actor_tpu.train.peract import iter_transitions as jax_iter
    from real_robot_nerf_actor_tpu_torch.train.peract import iter_transitions
    demos = [3, 5, 8]
    n = {3: 4, 5: 2, 8: 6}.__getitem__
    want = jax_iter(np.random.default_rng(7), demos, n, mode)
    got = iter_transitions(np.random.default_rng(7), demos, n, mode)
    assert [next(got) for _ in range(40)] == [next(want) for _ in range(40)]
    with pytest.raises(ValueError, match="sample_mode"):
        next(iter_transitions(np.random.default_rng(0), demos, n, "other"))


def test_predict_is_the_forward_without_grad():
    _, cfg = _configs()
    tr = PerActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    vox = torch.rand((1, 10, 10, 10, 10), generator=torch.Generator().manual_seed(1))
    proprio, lang = torch.zeros((1, 7)), torch.zeros((1, 4, 16))
    out = tr.predict(state, vox, proprio, lang)
    assert not any(o.requires_grad for o in out)
    with torch.no_grad():
        for a, b in zip(out, state.module(vox, proprio, lang)):
            assert torch.equal(a, b)


def test_final_conv_as_plain_gives_the_same_net():
    """convert.final_conv_as_plain: the kernel net's weights on the plain
    conv's net give the same outputs (CPU: the kernel path is the plain
    conv there too)."""
    from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    kw = {k: v for k, v in TINY.items() if k != "num_rotation_classes"}
    on = PerceiverIO.initialized(PerceiverConfig(**kw, conv_backend="pallas"),
                                 torch.Generator().manual_seed(0))
    off = PerceiverIO(PerceiverConfig(**kw))
    off.load_state_dict(final_conv_as_plain(on.state_dict()))
    vox = torch.rand((1, 10, 10, 10, 10), generator=torch.Generator().manual_seed(1))
    args = (vox, torch.ones((1, 7)), torch.zeros((1, 4, 16)))
    with torch.no_grad():
        for a, b in zip(on(*args), off(*args)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
