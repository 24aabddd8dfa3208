"""The port's real-camera act path against the JAX package, on frames made
from a numpy seed: the RealSense depth filters (bit-equal: both are numpy
float32 with the same arithmetic) over a 5-frame temporal sequence with
holes and edges, `depth_to_pointcloud`, `transform_points` and
`euler_to_quaternion`, the reference-signature shims of `compat.py`
(`VoxelGrid` padding, truncating, `only_features`, 2-D bounds; `gen_rays`;
`choose_highest_action` with a channel-first q_trans), and the slice as a
whole at a small policy (20^3 voxels, depth 1): filtered frames -> cloud ->
VoxelGrid -> policy -> decode, which must give JAX's indices on converted
weights, and `CameraActor` the same actions.

Tolerances: the filters exactly; points, quaternions and rays 1e-6 of
their scale (fp32 products in another order, the port's on the torch
side); voxel grids 1e-6 (scatter-means of the same points); decoded
indices exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu import compat as jcompat
from real_robot_nerf_actor_tpu.data import depth_filters as jdf
from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxConfig
from real_robot_nerf_actor_tpu.models import PerceiverIO as JaxPerceiverIO
from real_robot_nerf_actor_tpu.ops import action_codec as jcodec
from real_robot_nerf_actor_tpu.ops import geometry as jgeo
from real_robot_nerf_actor_tpu_torch import compat
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data import depth_filters as tdf
from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    REALSENSE_INTRINSICS, camera_extrinsic, camera_frames, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec, discretize_action
from real_robot_nerf_actor_tpu_torch.ops import geometry as tgeo
from real_robot_nerf_actor_tpu_torch.train.serve import CameraActor, PolicyServer, ServeConfig

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
HW = (48, 64)
K_SMALL = REALSENSE_INTRINSICS * np.array([[0.1], [0.1], [1.0]])   # 64 x 48 pixels


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


@pytest.fixture(scope="module")
def frames():
    """5 raw frames of the synthetic scene with holes (no point, and seeded
    dropout) and edges (the boxes against the table), and their colours."""
    scene = make_synthetic_scene(seed=0, n_points=30000)
    depth, rgb = camera_frames(scene, K_SMALL, camera_extrinsic(), HW, n_frames=5,
                               seed=1, noise=0.01, hole_frac=0.05)
    assert 0.02 < (depth == 0).mean() < 0.6 and depth.max() > 1.0
    return depth, rgb


@pytest.mark.parametrize("magnitude", [1, 5])
@pytest.mark.parametrize("holes_fill", [0, 1])
def test_depth_filters_bit_equal_to_jax(frames, magnitude, holes_fill):
    depth = frames[0]
    spatial = dict(magnitude=magnitude, holes_fill=holes_fill)
    want_pipe = jdf.DepthFilterPipeline(spatial=jdf.SpatialFilterConfig(**spatial))
    got_pipe = tdf.DepthFilterPipeline(spatial=tdf.SpatialFilterConfig(**spatial))
    for f in depth:
        want, got = want_pipe(f), got_pipe(f)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (got <= 1.0).all()          # the 1 m clip
    np.testing.assert_array_equal(got_pipe._state.value, want_pipe._state.value)
    np.testing.assert_array_equal(got_pipe._state.age, want_pipe._state.age)
    # the pieces one by one, and reset
    disp = tdf.depth_to_disparity(depth[0], 2.0)
    np.testing.assert_array_equal(disp, jdf.depth_to_disparity(depth[0], 2.0))
    np.testing.assert_array_equal(tdf.disparity_to_depth(disp, 2.0),
                                  jdf.disparity_to_depth(disp, 2.0))
    cfg = dict(magnitude=magnitude, holes_fill=holes_fill, smooth_delta=0.2)
    np.testing.assert_array_equal(tdf.spatial_filter(disp, tdf.SpatialFilterConfig(**cfg)),
                                  jdf.spatial_filter(disp, jdf.SpatialFilterConfig(**cfg)))
    t_state = j_state = None
    for f in depth:
        t_out, t_state = tdf.temporal_filter(f, t_state, tdf.TemporalFilterConfig(persistence=2))
        j_out, j_state = jdf.temporal_filter(f, j_state, jdf.TemporalFilterConfig(persistence=2))
        np.testing.assert_array_equal(t_out, j_out)
    got_pipe.reset()
    assert got_pipe._state is None
    np.testing.assert_array_equal(got_pipe(depth[0]), jdf.DepthFilterPipeline(
        spatial=jdf.SpatialFilterConfig(**spatial))(depth[0]))


def test_pointcloud_transform_and_quaternion_match_jax(frames):
    rng = np.random.default_rng(2)
    d = tdf.DepthFilterPipeline()(frames[0][0])
    want = jdf.depth_to_pointcloud(d, K_SMALL)
    np.testing.assert_array_equal(tdf.depth_to_pointcloud(d, K_SMALL), want)
    cam = tdf.depth_to_pointcloud(d, K_SMALL, device="cpu")
    _close(cam, want, 1e-6, "points on a named device")
    mats = np.stack([camera_extrinsic(), camera_extrinsic((0.1, -0.2, 0.5), (0.4, 0.3, 0.0))])
    pts = rng.standard_normal((2, 50, 3)).astype(np.float32)
    _close(tgeo.transform_points(torch.from_numpy(pts), torch.from_numpy(mats)),
           jgeo.transform_points(jnp.asarray(pts), jnp.asarray(mats)), 1e-6, "batched")
    flat = want.reshape(-1, 3)
    _close(tgeo.transform_points(torch.from_numpy(flat), torch.from_numpy(mats[0])),
           jgeo.transform_points(jnp.asarray(flat), jnp.asarray(mats[0])), 1e-6, "one")
    rpy = rng.uniform(-np.pi, np.pi, (7, 5, 3)).astype(np.float32)
    q = tgeo.euler_to_quaternion(torch.from_numpy(rpy))
    _close(q, jgeo.euler_to_quaternion(jnp.asarray(rpy)), 1e-6, "quaternion")
    _close(q.norm(dim=-1), np.ones((7, 5)), 1e-6, "unit")


@pytest.mark.parametrize("n,m", [(300, 500), (700, 500)])
def test_voxel_grid_pads_and_truncates_like_jax(n, m):
    rng = np.random.default_rng(n)
    coords = rng.uniform(-0.2, 0.8, (2, n, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    jg = jcompat.VoxelGrid(BOUNDS, 10, max_num_coords=m)
    tg = compat.VoxelGrid(BOUNDS, 10, device="cpu", max_num_coords=m)
    want = np.asarray(jg.coords_to_bounding_voxel_grid(coords, feats))
    got = tg.coords_to_bounding_voxel_grid(coords, feats)
    assert got.shape == (2, 10, 10, 10, 10)
    _close(got, want, 1e-6, "grid")
    # truncation keeps the first m points: the same grid as the first m alone
    if n > m:
        _close(got, tg.coords_to_bounding_voxel_grid(coords[:, :m], feats[:, :m]).numpy(),
               0.0, "first m")
    # 2-D bounds (the first row counts), only_features, no features
    b2 = np.array([[-0.2, -0.4, -0.3, 0.9, 0.8, 0.8], [0, 0, 0, 1, 1, 1]], np.float32)
    _close(tg.coords_to_bounding_voxel_grid(coords, feats, coord_bounds=b2, only_features=True),
           jg.coords_to_bounding_voxel_grid(coords, feats, coord_bounds=b2, only_features=True),
           1e-6, "2-D bounds, only_features")
    _close(tg.coords_to_bounding_voxel_grid(coords), jg.coords_to_bounding_voxel_grid(coords),
           1e-6, "no features")


def test_gen_rays_and_channel_first_decode_match_jax():
    rng = np.random.default_rng(4)
    poses = np.stack([camera_extrinsic(), camera_extrinsic((0.1, -0.2, 0.5), (0.4, 0.3, 0))])
    _close(compat.gen_rays(torch.from_numpy(poses), 8, 6, 5.0, 0.5, 2.0),
           jcompat.gen_rays(poses, 8, 6, 5.0, 0.5, 2.0), 1e-6, "rays")
    _close(compat.gen_rays(torch.from_numpy(poses), 8, 6, [5.0, 4.0], 0.5, 2.0, c=[3.5, 2.5]),
           jcompat.gen_rays(poses, 8, 6, [5.0, 4.0], 0.5, 2.0, c=[3.5, 2.5]), 1e-6, "c")
    q_trans = rng.standard_normal((3, 1, 6, 6, 6)).astype(np.float32)
    q_rg = rng.standard_normal((3, 3 * 72 + 2)).astype(np.float32)
    q_coll = rng.standard_normal((3, 2)).astype(np.float32)
    want = jcompat.choose_highest_action(q_trans, q_rg, q_coll)
    # arrays follow the device of a tensor among the three (here the CPU)
    for args in ((torch.from_numpy(q_trans), q_rg, q_coll),
                 tuple(torch.from_numpy(a) for a in (q_trans, q_rg, q_coll)),
                 (torch.from_numpy(q_trans[:, 0]), torch.from_numpy(q_rg),
                  torch.from_numpy(q_coll))):
        got = compat.choose_highest_action(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


MODEL = dict(depth=1, voxel_size=20, num_latents=16, latent_dim=32, im_channels=8,
             cross_dim_head=8, latent_dim_head=8, latent_heads=2, voxel_patch_size=5,
             final_dim=8, lang_emb_dim=16, lang_max_seq_len=4, input_encoder="unet")


@pytest.mark.parametrize("max_num_coords", [1000, 4000])
def test_camera_slice_gives_jax_indices(frames, max_num_coords):
    """Frames -> filters -> cloud -> crop -> VoxelGrid -> policy -> decode,
    in both packages on the same frames and converted weights (1000 points
    truncates the cloud, 4000 pads it); CameraActor gives the same
    actions."""
    depth, rgb = frames
    v = MODEL["voxel_size"]
    variables = JaxPerceiverIO(JaxConfig(**MODEL)).init(
        jax.random.key(0), jnp.zeros((1, v, v, v, 10)), jnp.zeros((1, 7)),
        jnp.zeros((1, 4, 16)))
    jnet = JaxPerceiverIO(JaxConfig(**MODEL))
    lang = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    spec = VoxelizerSpec(voxel_size=v, feature_size=3, max_num_coords=max_num_coords)
    server = PolicyServer(ServeConfig(coord_bounds=BOUNDS), PerceiverConfig(**MODEL), spec,
                          flax_to_state_dict(variables), lang, device="cpu")
    ext = camera_extrinsic()
    actor = CameraActor(server, K_SMALL, ext)
    jgrid = jcompat.VoxelGrid(BOUNDS, v, max_num_coords=max_num_coords)
    tgrid = compat.VoxelGrid(BOUNDS, v, device="cpu", max_num_coords=max_num_coords)
    jpipe = jdf.DepthFilterPipeline()
    prop = (np.array([0.3, 0.1, 0.1], np.float32), np.array([10.0, -20.0, 30.0], np.float32), 1.0)
    jb = jnp.asarray(BOUNDS, jnp.float32)
    tb = torch.tensor(BOUNDS)
    counts = []
    for f in depth:
        filtered = jpipe(f)
        # JAX: the cloud in the world, cropped in pixel order
        cam = jdf.depth_to_pointcloud(filtered, K_SMALL).reshape(-1, 3)
        world = np.asarray(jgeo.transform_points(jnp.asarray(cam), jnp.asarray(ext)))
        keep = ((cam[:, 2] > 0) & (world >= np.array(BOUNDS[:3])).all(-1)
                & (world <= np.array(BOUNDS[3:])).all(-1))
        cols = (rgb.reshape(-1, 3)[keep] - 0.5) / 0.5
        counts.append(int(keep.sum()))
        jvox = jgrid.coords_to_bounding_voxel_grid(world[keep][None], cols[None])
        prev = jcodec.discretize_action(jnp.asarray(prop[0])[None], jnp.asarray(prop[1])[None],
                                        jnp.asarray([prop[2]]), jnp.ones(1), jb, v, 5.0)
        jprop = jnp.concatenate([prev.trans.astype(jnp.float32),
                                 prev.rot_grip.astype(jnp.float32)], -1)
        want = jcompat.choose_highest_action(*jnet.apply(variables, jvox, jprop,
                                                         jnp.asarray(lang)[None])[:3])

        # the port, through the same shims
        tfilt = actor.filters(f)
        np.testing.assert_array_equal(tfilt, filtered)
        pts, tcols = actor.points(tfilt, rgb)
        assert pts.shape[0] == counts[-1]
        _close(pts, world[keep], 1e-6, "world points")
        tvox = tgrid.coords_to_bounding_voxel_grid(pts[None], tcols[None])
        _close(tvox, jvox, 1e-6, "grid")
        tprev = discretize_action(torch.from_numpy(prop[0])[None], torch.from_numpy(prop[1])[None],
                                  torch.tensor([prop[2]]), torch.ones(1), tb, v, 5.0)
        tprop = torch.cat([tprev.trans.float(), tprev.rot_grip.float()], -1)
        with torch.no_grad():
            got = compat.choose_highest_action(*server.net(tvox, tprop, server.lang)[:3])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # CameraActor's step on the same filtered frame: the same indices
        packed = actor.step(tfilt, rgb, *prop)[0]
        xyz = tgeo.voxel_index_to_point(got[0], v, tb)[0]
        assert torch.equal(packed[:3], xyz)
        assert torch.equal(packed[3:6], (got[1][0, :3].float() + 1.0) * 5.0 - 180.0)
        assert packed[6].item() == got[1][0, 3].item() and packed[7].item() == got[2][0, 0].item()
    # the crop left more points than 1000 and fewer than 4000 in every frame
    assert all(1000 < c < 4000 for c in counts), counts
    assert actor.last_num_points == counts[-1]
    # act on a raw frame runs the filters itself (the temporal state carries)
    actor.reset()
    out = [actor.act(f, rgb, *prop) for f in depth]
    assert all(np.isfinite(o[0]).all() and o[2] in (0, 1) for o in out)
