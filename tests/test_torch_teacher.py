"""The FeatureNeRF contrastive teacher of the PyTorch port
(`train/teacher.py`, `convert.read_flax_msgpack`, `teacher_to_state_dict`)
and the pixelNeRF family's last two models (`encoder2d.ConvEncoder`,
`implicit.ImplicitNet`), against the JAX package.

Tolerances (fp32): `match_pixels` equal, and the numpy Generator in the
same state after it; the forward 1e-5 of the output's largest |value|; one
train step: loss and metrics 1e-5 relative, gradients 1e-3 of each
tensor's largest |g| (in float64 both packages give the same gradients to
5e-8 of scale; in fp32 the JAX package's sit up to 1.7e-4 of scale from
their float64 values, the port's 6e-6: XLA's fp32 sums through the 2-D
ResNet in train mode), the parameters after the adam step within 1e-6 plus
lr * min(2, 1e-3 max|g| / |g|) (adam's first step moves a parameter by
lr * g / (|g| + eps): where |g| is within the gradients' tolerance of
zero, its sign, and so the step, is not determined), the BatchNorm running
statistics 1e-4 of their scale (a batch mean over 512 positions of
activations through four convs; measured 2.1e-5); `feature_maps` 1e-5 of scale (attention
2e-5 absolute: a percentile over fp32 energies); `teacher_quality` 1e-4.
The committed JAX teacher's features at 64 x 64: 1e-4 of scale (a
13-conv ResNet at full width). ConvEncoder and ImplicitNet: 1e-5 of scale.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models.encoder2d import ConvEncoder as JaxConvEncoder
from real_robot_nerf_actor_tpu.models.encoder2d import SpatialEncoderConfig as JaxEncCfg
from real_robot_nerf_actor_tpu.models.implicit import ImplicitNet as JaxImplicit
from real_robot_nerf_actor_tpu.train import teacher as jt
from real_robot_nerf_actor_tpu_torch import convert
from real_robot_nerf_actor_tpu_torch.data.scene_dataset import (
    load_scene, save_scene, synthesize_scene_npz)
from real_robot_nerf_actor_tpu_torch.data.synthetic import make_synthetic_scene
from real_robot_nerf_actor_tpu_torch.models.encoder2d import ConvEncoder, SpatialEncoderConfig
from real_robot_nerf_actor_tpu_torch.models.implicit import ImplicitNet
from real_robot_nerf_actor_tpu_torch.train import teacher as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSGPACK = os.path.join(REPO, "artifacts", "round5_featurenerf", "teacher.msgpack")
NARROW = dict(stage_features=(8, 8, 16, 16), blocks_per_stage=1)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def splat_depth(seed, poses, h, w, focal):
    """z-depth of the synthetic scene's points splatted as the scene's
    images are (nearest point a pixel; inf where none lands): consistent
    with match_pixels' principal point at ((w-1)/2, (h-1)/2)."""
    scene = make_synthetic_scene(seed=seed)
    out = np.full((len(poses), h, w), np.inf, np.float32)
    for v, pose in enumerate(poses):
        w2c = np.linalg.inv(pose)
        p = scene.points @ w2c[:3, :3].T + w2c[:3, 3]
        z = -p[:, 2]
        keep = z > 1e-3
        p, z = p[keep], z[keep]
        u = (focal * p[:, 0] / z + w / 2).astype(np.int32)
        r = (-focal * p[:, 1] / z + h / 2).astype(np.int32)
        ok = (u >= 0) & (u < w) & (r >= 0) & (r < h)
        np.minimum.at(out[v], (r[ok], u[ok]), z[ok].astype(np.float32))
    return out


def write_scenes(root, n, views, hw):
    for i in range(n):
        path = os.path.join(root, f"scene_{i}.npz")
        sc = synthesize_scene_npz(path, n_views=views, hw=hw, seed=i)
        sc.depth = splat_depth(i, sc.poses, hw[0], hw[1], sc.focal)
        sc.features = None
        save_scene(path, sc)
    return sorted(glob.glob(os.path.join(root, "*.npz")))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return [load_scene(p) for p in write_scenes(str(root), 2, 6, (32, 32))]


def test_match_pixels_equals_jax(scenes):
    sc = scenes[0]
    hits = 0
    for i, j in ((0, 1), (1, 3), (2, 5), (4, 0)):
        ra, rb = np.random.default_rng(i), np.random.default_rng(i)
        want = jt.match_pixels(sc.poses, sc.focal, sc.depth, i, j, 24, ra)
        got = tt.match_pixels(sc.poses, sc.focal, sc.depth, i, j, 24, rb)
        assert (want is None) == (got is None)
        if want is not None:
            hits += 1
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert ra.bit_generator.state == rb.bit_generator.state
    assert hits >= 2


def _jax_state(cfg_j, hw, seed=0):
    tr = jt.TeacherTrainer(cfg_j)
    return tr, tr.init_state(jax.random.key(seed), hw)


def _port_state(cfg_t, state_j):
    tr = tt.TeacherTrainer(cfg_t, device="cpu")
    st = tr.init_state(torch.Generator().manual_seed(0))
    st.module.load_state_dict(convert.teacher_to_state_dict(
        jax.device_get(state_j["params"]), jax.device_get(state_j["extra"]["batch_stats"])))
    return tr, st


def _configs(**kw):
    return (jt.TeacherConfig(encoder=JaxEncCfg(**NARROW), **kw),
            tt.TeacherConfig(encoder=SpatialEncoderConfig(**NARROW), **kw))


def test_train_step_matches_jax(scenes):
    cfg_j, cfg_t = _configs(d_embed=8, n_pairs=24)
    sc = scenes[0]
    m = tt.match_pixels(sc.poses, sc.focal, sc.depth, 0, 1, 24, np.random.default_rng(0))
    imgs = np.stack([sc.images[0], sc.images[1]]).astype(np.float32)
    trj, sj = _jax_state(cfg_j, (32, 32))
    trt, st = _port_state(cfg_t, sj)
    # the forward in inference mode
    want = trj.net.apply({"params": sj["params"], **sj["extra"]}, jnp.asarray(imgs))
    with torch.no_grad():
        got = st.module(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    # one step: loss, metrics, gradients, parameters, running statistics
    args = (jnp.asarray(imgs), jnp.asarray(m[0]), jnp.asarray(m[1]), True)
    (_, (_, want_m)), want_g = jax.value_and_grad(trj._loss, has_aux=True)(
        sj["params"], sj["extra"], *args)
    sj2, _ = trj.make_step()(sj, *args[:3])
    st, got_m = trt.train_step(st, torch.from_numpy(imgs), torch.from_numpy(m[0]),
                               torch.from_numpy(m[1]))
    for k, w in want_m.items():
        np.testing.assert_allclose(float(got_m[k]), float(w), rtol=1e-5, err_msg=k)
    net = st.module
    want_gsd = convert.teacher_to_state_dict(jax.device_get(want_g))
    named = dict(net.named_parameters())
    assert set(want_gsd) == set(named)
    for n, w in want_gsd.items():
        torch.testing.assert_close(named[n].grad, w, rtol=0,
                                   atol=1e-3 * w.abs().max().item() + 1e-30,
                                   msg=lambda s: f"grad {n}: {s}")
    after = convert.teacher_to_state_dict(jax.device_get(sj2["params"]),
                                          jax.device_get(sj2["extra"]["batch_stats"]))
    sd = net.state_dict()
    for n, w in after.items():
        if n in named:
            g = want_gsd[n].abs()
            tol = 1e-6 + cfg_t.lr * torch.clamp(1e-3 * g.max() / g, max=2.0)
            assert ((sd[n] - w).abs() <= tol).all(), n
        else:
            torch.testing.assert_close(sd[n], w, rtol=0, atol=1e-4 * w.abs().max().item(),
                                       msg=lambda s: f"{n}: {s}")
    assert st.step == 1 and st.optimizer.count == 1


def test_feature_maps_and_quality_match_jax(scenes):
    cfg_j, cfg_t = _configs(d_embed=8)
    trj, sj = _jax_state(cfg_j, (32, 32), seed=3)
    trt, st = _port_state(cfg_t, sj)
    images = scenes[1].images
    fj, aj = trj.feature_maps(sj, images, batch=4)
    ft, at = trt.feature_maps(st, images, batch=4)
    assert ft.shape == (6, 16, 16, 8) and at.shape == (6, 16, 16)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-5 * np.abs(fj).max())
    np.testing.assert_allclose(at, aj, rtol=0, atol=2e-5)
    qj = jt.teacher_quality(sj, trj, scenes, np.random.default_rng(123), n_pairs=24)
    qt = tt.teacher_quality(st, trt, scenes, np.random.default_rng(123), n_pairs=24)
    assert qj.keys() == qt.keys()
    for k in qj:
        assert abs(qj[k] - qt[k]) <= 1e-4, (k, qj[k], qt[k])


def test_read_flax_msgpack_equals_flax():
    from flax import serialization
    with open(MSGPACK, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = convert.read_flax_msgpack(MSGPACK)
    (lw, tw), (lg, tg) = (jax.tree_util.tree_flatten_with_path(t) for t in (want, got))
    assert tw == tg and len(lw) == 172
    for (path, a), (_, b) in zip(lw, lg):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert int(got["opt"]["0"]["count"]) == 3000


def test_read_flax_msgpack_round_trips_scalars_and_lists(tmp_path):
    """Every msgpack format flax writes for a tree of numpy leaves, python
    scalars, strings and lists, and chunked arrays."""
    from flax import serialization
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3), "b": {"c": np.float32(2.5),
            "d": [1, -7, 300, 70000, -40000, 2 ** 40, 1.5, True, None, "s" * 40]},
            "e": np.zeros((0, 4), np.float32), "f": np.arange(3, dtype=np.uint8),
            "g": np.ones((3,), np.float16), "z": 1 + 2j}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = convert.read_flax_msgpack(str(path))
    want = serialization.msgpack_restore(path.read_bytes())
    (lw, tw), (lg, tg) = (jax.tree_util.tree_flatten(t) for t in (want, got))
    assert tw == tg
    for a, b in zip(lw, lg):
        assert type(a) is type(b) or (np.asarray(a).dtype == np.asarray(b).dtype)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    chunked = {"x": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 2},
                     "chunks": {"0": np.arange(3.0), "1": np.arange(1.0)}}}
    path.write_bytes(serialization.msgpack_serialize(chunked))
    np.testing.assert_array_equal(convert.read_flax_msgpack(str(path))["x"],
                                  [[0.0, 1.0], [2.0, 0.0]])


def test_committed_teacher_features_match_jax(scenes):
    """The trained JAX teacher (artifacts/round5_featurenerf/teacher.msgpack),
    read without flax and converted, at 64 x 64."""
    from flax import serialization
    cfg = jt.TeacherConfig()
    trj = jt.TeacherTrainer(cfg)
    sj = trj.init_state(jax.random.key(0), (64, 64))
    with open(MSGPACK, "rb") as f:
        sj = serialization.from_bytes(sj, f.read())
    trt = tt.TeacherTrainer(tt.TeacherConfig(), device="cpu")
    st = tt.load_teacher_state(MSGPACK, trt.init_state())
    assert st.step == 3000 and st.optimizer.count == 3000
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    images[:, 16:48, 16:48] = scenes[0].images[:2, :32, :32]
    fj, aj = trj.feature_maps(sj, images)
    ft, at = trt.feature_maps(st, images)
    assert ft.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4 * np.abs(fj).max())
    # the adam moments came across: mu of the proj kernel, transposed
    mu = st.optimizer.adamw.state[dict(st.module.named_parameters())["proj.weight"]]
    np.testing.assert_array_equal(mu["exp_avg"].numpy(),
                                  np.asarray(sj["opt"][0].mu["proj"]["kernel"]).T)


def test_cli_trains_dumps_saves_and_resumes(tmp_path, capsys):
    root = str(tmp_path / "scenes")
    os.makedirs(root)
    paths = write_scenes(root, 3, 4, (32, 32))
    out, qual = str(tmp_path / "t.pt"), str(tmp_path / "q.json")
    q = tt.main(["--data-root", root, "--steps", "2", "--n-pairs", "16", "--dump",
                 "--out", out, "--quality-out", qual, "--device", "cpu"])
    log = capsys.readouterr().out
    assert "[teacher] step 0 loss=" in log and "[teacher] step 1 " in log
    assert set(q) == {"matched_cosine", "random_cosine", "teacher_corr_at2px"}
    assert os.path.exists(qual) and os.path.exists(out)
    for p in paths:
        sc = load_scene(p)
        assert sc.features.shape == (4, 16, 16, 64) and sc.cls_attn.shape == (4, 16, 16)
        assert sc.depth is not None
    # resume from the --out file (no step) dumps the same features
    first = load_scene(paths[0]).features
    tt.main(["--data-root", root, "--steps", "0", "--dump", "--resume", out,
             "--device", "cpu"])
    np.testing.assert_array_equal(load_scene(paths[0]).features, first)
    # resume from the JAX package's msgpack, a step on top
    tt.main(["--data-root", root, "--steps", "1", "--n-pairs", "16", "--dump",
             "--resume", MSGPACK, "--out", out, "--device", "cpu"])
    assert "resumed" in capsys.readouterr().out
    saved = torch.load(out, weights_only=True)
    assert saved["step"] == 3001 and saved["opt_state"]["count"] == 3001


def _pert(variables, seed):
    """flax's init zeroes biases and sets GroupNorm scales to one: redraw
    every leaf around its value, so that each parameter is exercised."""
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
              for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("hw,skip", [((64, 64), True), ((48, 40), False)])
def test_conv_encoder_matches_jax(hw, skip):
    kw = dict(dim_in=3, first_channels=8, mid_channels=16, last_channels=12,
              n_down_layers=2, use_skip_conn=skip)
    jm = JaxConvEncoder(**kw)
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    variables = _pert(jm.init(jax.random.key(1), jnp.asarray(x)), 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    ours = ConvEncoder(**kw, image_hw=hw)
    ours.load_state_dict(convert.flax_to_state_dict(variables))
    xt = torch.from_numpy(x).requires_grad_()
    got = ours(xt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # and its gradient with respect to the input
    cot = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jm.apply(variables, v), jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(cot))[0])
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0,
                               atol=1e-5 * np.abs(want_g).max())


def test_conv_encoder_at_the_reference_width():
    """128 x 128 at the defaults: the flattened bottleneck 2 x 2 x 128."""
    m = ConvEncoder()
    from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
    init_weights(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = m(torch.randn(1, 128, 128, 3, generator=torch.Generator().manual_seed(1)))
    assert out.shape == (1, 128, 128, 128) and torch.isfinite(out).all()
    assert m.deconv2.weight.shape == (512 + 512, 256, 3, 3)


@pytest.mark.parametrize("beta,views,combine", [(0.0, 1, 1000), (100.0, 2, 2)])
def test_implicit_net_matches_jax(beta, views, combine):
    kw = dict(d_in=9, dims=[32, 32, 32], d_out=4, skip_in=(2,), beta=beta,
              combine_layer=combine)
    jm = JaxImplicit(**kw)
    x = np.random.default_rng(0).standard_normal((12, 9)).astype(np.float32)
    variables = _pert(jm.init(jax.random.key(0), jnp.asarray(x)), 3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), num_views=views))
    ours = ImplicitNet(**kw)
    ours.load_state_dict(convert.flax_to_state_dict(variables))
    got = ours(torch.from_numpy(x), num_views=views).detach().numpy()
    assert got.shape == want.shape == (12 // views, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_implicit_net_geometric_init():
    """As tests/test_aux_models.py holds the JAX net: the first output
    positive at the origin and lower far away; the layer before a skip
    emits dims[l] - d_in; the positional tail zeroed; the init's spread
    as flax draws it."""
    from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
    net = init_weights(ImplicitNet(d_in=3, dims=[64, 64, 64], d_out=4, skip_in=(2,),
                                   radius_init=0.3), torch.Generator().manual_seed(0))
    with torch.no_grad():
        near = net(torch.zeros(1, 3))
        far = net(torch.ones(1, 3) * 2.0)
    assert near[0, 0] > 0 and far[0, 0] < near[0, 0]
    assert net.lin1.weight.shape == (64 - 3, 64) and net.lin2.weight.shape == (64, 64)
    jp = JaxImplicit(d_in=3, dims=[64, 64, 64], d_out=4, skip_in=(2,)).init(
        jax.random.key(0), jnp.zeros((1, 3)))["params"]
    for name in ("lin0", "lin1", "lin3"):
        w = getattr(net, name).weight.detach().numpy().T
        wj = np.asarray(jp[name]["kernel"])
        if name == "lin3":        # column 0: the sphere's; the rest N(0, 2^2)
            np.testing.assert_allclose(w[:, 0].mean(), wj[:, 0].mean(), rtol=1e-3)
            w, wj = w[:, 1:], wj[:, 1:]
        assert abs(w.std() / wj.std() - 1) < 0.15, name
    assert net.lin3.bias[0] == 0.3 and (net.lin3.bias[1:] == 0).all()
    tail = init_weights(ImplicitNet(d_in=9, dims=[16, 16], skip_in=(1,)),
                        torch.Generator().manual_seed(0))
    assert (tail.lin0.weight[:, 3:] == 0).all() and (tail.lin1.weight[:, -6:] == 0).all()
    assert (tail.lin0.weight[:, :3] != 0).all()
    soft = init_weights(ImplicitNet(d_in=3, dims=[32, 32], d_out=2, beta=100.0,
                                    geometric_init=False), torch.Generator().manual_seed(1))
    assert torch.isfinite(soft(torch.randn(5, 3))).all()
