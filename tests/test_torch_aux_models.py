"""The auxiliary models of the port against the JAX package: the CNN policy
heads (`Conv2DBlock`, `FiLM`, `SiameseNet`, `CNNAndFcsNet`,
`CNNLangAndFcsNet`, `SpatialSoftmax2D`), the VL fusion modules
(`VLCrossAttention`, `Visual3DLangTransformer`,
`LanguageInformedVisualAttention`) and the deep UNet `MultiLayer3DEncoder`.
The flax variables are redrawn at random (the VL gate non-zero, so that the
attention reaches the output) and converted by `convert.flax_to_state_dict`;
inputs come from a numpy seed. Held: the forward, and the gradients of a
fixed linear functional of the outputs with respect to every float input
and every parameter, against `jax.grad`; images of odd and even sides
(flax's "SAME" padding is asymmetric on an even side).

Tolerances: fp32 forward 1e-5 of each output's largest |value|, gradients
1e-4 of each tensor's largest |g| (the same sums in another order); bf16
(the VL modules' compute dtype) forward 2^-6 and gradients 2^-5 of the
scale (bf16 rounds at the same points in both, and a one-ulp difference of
an input to a rounding, 2^-8, can carry through a product or two), each
gradient entry widened by the JAX module's own bf16-vs-fp32 gap there: JAX
runs the backward's cotangents in bf16, so a gradient that is a long sum
with cancellation (the scalar gate's) sits up to 8% of itself from its
fp32 value in JAX, where the port's sits 0.8% away.
MultiLayer3DEncoder in train mode also holds the updated running
statistics (1e-5), then the eval mode on them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models import blocks as jb
from real_robot_nerf_actor_tpu.models import cnn_policies as jcnn
from real_robot_nerf_actor_tpu.models import vl_attention as jvl
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import MultiLayer3DEncoder
from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
from real_robot_nerf_actor_tpu_torch.models import cnn_policies as tcnn
from real_robot_nerf_actor_tpu_torch.models import vl_attention as tvl

FP32 = (1e-5, 1e-4)
BF16 = (2 ** -6, 2 ** -5)


def _randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if name == "gate":
            return jnp.asarray(rng.uniform(0.5, 1.0, a.shape), jnp.float32)
        return jnp.asarray(rng.standard_normal(a.shape) * 0.3, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _close(got, want, rel, what, slack=0.0):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    tol = rel * max(float(np.abs(want).max()), 1e-30) + slack
    assert np.all(np.abs(got - want) <= tol), (
        f"{what}: largest gap {np.abs(got - want).max()}, bound {np.max(tol)}")


def _flat(tree):
    """Leaves of nested lists / tuples, in order."""
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _check(jm, tm, inputs, tols=FP32, seed=0, jm_fp32=None):
    """inputs: positional args of both modules (numpy arrays, or lists of
    them); every float input is differentiated. jm_fp32: the JAX module in
    fp32, whose gradients widen each bound by JAX's own bf16 gap."""
    fwd_tol, grad_tol = tols
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    variables = {"params": {}, **_randomize(jm.init(jax.random.key(0), *jin), seed)}
    want_out = jm.apply(variables, *jin)
    rng = np.random.default_rng(seed + 1)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in _flat(jax.tree_util.tree_leaves(want_out))]

    def loss(params, args):
        out = jax.tree_util.tree_leaves(jm.apply({**variables, "params": params}, *args))
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(out, cots))

    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jin)
    slack = {}
    if jm_fp32 is not None:
        def loss32(params, args):
            out = jax.tree_util.tree_leaves(jm_fp32.apply({"params": params}, *args))
            return sum(jnp.sum(o * c) for o, c in zip(out, cots))

        g32p, g32x = jax.grad(loss32, argnums=(0, 1))(variables["params"], jin)
        for k, w in flax_to_state_dict({"params": g32p}).items():
            slack[k] = np.abs(flax_to_state_dict({"params": want_gp})[k].numpy() - w.numpy())
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(want_gx),
                                       jax.tree_util.tree_leaves(g32x))):
            slack[i] = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))

    tm.load_state_dict(flax_to_state_dict(variables))
    tin = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(),
                                 inputs)
    out = _flat(tm(*tin))
    assert len(out) == len(cots)
    for i, (o, w) in enumerate(zip(out, jax.tree_util.tree_leaves(want_out))):
        _close(o, w, fwd_tol, f"output {i}")
    sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(out, cots)).backward()
    for i, (x, g) in enumerate(zip(_flat(tin), jax.tree_util.tree_leaves(want_gx))):
        _close(x.grad, g, grad_tol, f"d input {i}", slack.get(i, 0.0))
    want_g = flax_to_state_dict({"params": want_gp})
    named = dict(tm.named_parameters())
    assert set(want_g) == set(named)
    for k, w in want_g.items():
        _close(named[k].grad, w.numpy(), grad_tol, f"d {k}", slack.get(k, 0.0))


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


SIDES = [(16, 16), (15, 17)]


@pytest.mark.parametrize("hw", SIDES)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_block(hw, stride):
    _check(jcnn.Conv2DBlock(6, 3, stride, "lrelu"), tcnn.Conv2DBlock(3, 6, 3, stride, "lrelu"),
           (_x((2, *hw, 3)),))


def test_film():
    _check(jcnn.FiLM(), tcnn.FiLM(8, 5), (_x((3, 4, 6, 5)), _x((3, 8), 2)))


@pytest.mark.parametrize("hw", SIDES)
def test_siamese_net(hw):
    _check(jcnn.SiameseNet(), tcnn.SiameseNet(3),
           ([_x((2, *hw, 3)), _x((2, *hw, 3), 2)],))


@pytest.mark.parametrize("hw", SIDES)
def test_cnn_and_fcs_net(hw):
    _check(jcnn.CNNAndFcsNet(fc_layers=(32, 16), out_dim=5),
           tcnn.CNNAndFcsNet(3, hw, 4, fc_layers=(32, 16), out_dim=5),
           (_x((3, *hw, 3)), _x((3, 4), 2)))


@pytest.mark.parametrize("hw", SIDES)
def test_cnn_lang_and_fcs_net(hw):
    _check(jcnn.CNNLangAndFcsNet(fc_layers=(32, 16), out_dim=5),
           tcnn.CNNLangAndFcsNet(3, hw, 4, 12, fc_layers=(32, 16), out_dim=5),
           (_x((3, *hw, 3)), _x((3, 4), 2), _x((3, 12), 3)))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_spatial_softmax_2d(hw):
    """Inputs at the temperature's scale, so that the softmax is not a
    one-hot."""
    _check(jcnn.SpatialSoftmax2D(), tcnn.SpatialSoftmax2D(), (_x((2, *hw, 5), scale=0.02),))


@pytest.mark.parametrize("dtype,tols", [("float32", FP32), ("bfloat16", BF16)])
def test_vl_cross_attention(dtype, tols):
    _check(jvl.VLCrossAttention(2, 8, dtype=getattr(jnp, dtype)),
           tvl.VLCrossAttention(16, 12, 2, 8, dtype=getattr(torch, dtype)),
           (_x((2, 10, 16)), _x((2, 7, 12), 2)), tols,
           jm_fp32=jvl.VLCrossAttention(2, 8) if dtype == "bfloat16" else None)


def test_vl_cross_attention_ungated_and_fresh_gate():
    """gated=False adds the attention unscaled; a fresh gated block is the
    identity (the gate initialises to zero)."""
    _check(jvl.VLCrossAttention(2, 8, gated=False), tvl.VLCrossAttention(16, 12, 2, 8, gated=False),
           (_x((2, 10, 16)), _x((2, 7, 12), 2)))
    m = init_weights(tvl.VLCrossAttention(16, 12, 2, 8), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 10, 16)))
    with torch.no_grad():
        assert torch.equal(m(x, torch.from_numpy(_x((2, 7, 12), 2))), x)


@pytest.mark.parametrize("dtype,tols", [("float32", FP32), ("bfloat16", BF16)])
def test_visual3d_lang_transformer(dtype, tols):
    _check(jvl.Visual3DLangTransformer(depth=2, n_heads=2, d_head=8, dtype=getattr(jnp, dtype)),
           tvl.Visual3DLangTransformer(16, 12, depth=2, n_heads=2, d_head=8,
                                       dtype=getattr(torch, dtype)),
           (_x((2, 10, 16)), _x((2, 7, 12), 2)), tols,
           jm_fp32=(jvl.Visual3DLangTransformer(depth=2, n_heads=2, d_head=8)
                    if dtype == "bfloat16" else None))


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 16), (2, 9, 16)])
def test_language_informed_visual_attention(shape):
    _check(jvl.LanguageInformedVisualAttention(),
           tvl.LanguageInformedVisualAttention(16, 12), (_x(shape), _x((2, 12), 2)))


@pytest.mark.parametrize("v", [20, 25])
def test_multilayer_3d_encoder_train_and_eval(v):
    """Train mode: batch statistics, the updated running statistics, the
    output, the skip sums of voxel_list and the gradients; then the eval
    mode on the updated statistics, which it leaves as they are."""
    jm, tm = jb.MultiLayer3DEncoder(8), MultiLayer3DEncoder(6, 8)
    rng = np.random.default_rng(v)
    x = (rng.standard_normal((1, v, v, v, 6)) * 1.7 + 0.6).astype(np.float32)
    variables = _randomize(jm.init(jax.random.key(0), jnp.asarray(x), train=False))
    shapes = jax.eval_shape(lambda: jm.apply(variables, jnp.asarray(x), train=False))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert [s.shape[1] for s in leaves] == [v, v, -(-v // 4), -(-v // 2)]
    cots = [rng.standard_normal(s.shape).astype(np.float32) for s in leaves]

    def loss(params, xx):
        out, new = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            xx, train=True, mutable=["batch_stats"])
        ys = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum(y * c) for y, c in zip(ys[1:], cots[1:])) \
            + jnp.sum(ys[0] * cots[0]), (ys, new["batch_stats"])

    (_, (want_ys, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    tm.load_state_dict(flax_to_state_dict(variables))
    xt = torch.from_numpy(x).requires_grad_()
    out, vlist = tm(xt, train=True)
    ys = [out] + vlist
    sum((y * torch.from_numpy(c)).sum() for y, c in zip(ys[1:], cots[1:])).add(
        (ys[0] * torch.from_numpy(cots[0])).sum()).backward()
    for i, (y, w) in enumerate(zip(ys, want_ys)):
        _close(y, w, 1e-5, f"output {i}")
    sd = tm.state_dict()
    for k, w in flax_to_state_dict({"batch_stats": want_stats}).items():
        _close(sd[k], w.numpy(), 1e-5, k)
    _close(xt.grad, want_gx, 1e-4, "d input")
    named = dict(tm.named_parameters())
    want_g = flax_to_state_dict({"params": want_gp})
    assert set(want_g) == set(named)
    for k, w in want_g.items():
        _close(named[k].grad, w.numpy(), 1e-4, f"d {k}")

    before = {k: t.clone() for k, t in tm.state_dict().items()}
    want_eval = jax.tree_util.tree_leaves(jm.apply(
        {"params": variables["params"], "batch_stats": want_stats}, jnp.asarray(x),
        train=False))
    with torch.no_grad():
        got_out, got_list = tm(torch.from_numpy(x))
    for i, (y, w) in enumerate(zip([got_out] + got_list, want_eval)):
        _close(y, w, 1e-5, f"eval output {i}")
    assert all(torch.equal(before[k], t) for k, t in tm.state_dict().items())
