"""The render panels and voxel views of the PyTorch port
(`utils/visualize.py`, numpy and the port's PNG codec) against the JAX
package's matplotlib figures: the arrays it hands to `imshow` and
`scatter` (captured by a monkeypatch: the tests import matplotlib, the
port does not), the viridis table within 1/255 of matplotlib's, and
the evals writing the JAX package's file names (render_eval here;
the replay evals in tests/test_torch_replay.py's CLI test, novel --out in
tests/test_torch_featurenerf.py's)."""
import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from real_robot_nerf_actor_tpu.utils import visualize as jv  # noqa: E402
from real_robot_nerf_actor_tpu_torch.data.png import read_png, read_png_text, write_png  # noqa: E402
from real_robot_nerf_actor_tpu_torch.utils import visualize as tv  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(seed=0, h=6, w=9, finite=True):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    rgb = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
    if not finite:
        depth[0, :3] = np.inf
        depth[2, 1] = np.nan
    embed = rng.standard_normal((h, w, 5)).astype(np.float32)
    return gt, rgb, depth, embed


@pytest.mark.parametrize("case", ["all", "non_finite_depth", "rgb_only", "embed_2ch"])
def test_render_panels_are_the_arrays_jax_shows(tmp_path, monkeypatch, case):
    from matplotlib.axes import Axes
    shown, titles = [], []
    monkeypatch.setattr(Axes, "imshow", lambda self, img, cmap=None, **kw: shown.append(
        (np.asarray(img), cmap)))
    set_title = Axes.set_title
    monkeypatch.setattr(Axes, "set_title", lambda self, t, *a, **kw: (
        titles.append(t), set_title(self, t, *a, **kw))[1])
    gt, rgb, depth, embed = _views(finite=case != "non_finite_depth")
    kw = {"all": dict(depth=depth, embed=embed), "non_finite_depth": dict(depth=depth),
          "rgb_only": {}, "embed_2ch": dict(embed=embed[..., :2])}[case]
    jv.save_render_panel(str(tmp_path / "jax.png"), gt, rgb, psnr=21.5, **kw)
    panels = tv.render_panels(gt, rgb, **kw)
    assert [n for n, _ in panels] == titles
    for (name, got), (want, cmap) in zip(panels, shown):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (cmap == "viridis") == (got.ndim == 2)
    image = tv.save_render_panel(str(tmp_path / "port.png"), gt, rgb, psnr=21.5, **kw)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), image)
    assert read_png_text(str(tmp_path / "port.png"))["PSNR"] == "21.50"
    widths = [a.shape[1] for _, a in panels]
    assert image.shape == (6, sum(widths) + tv.GAP * (len(widths) - 1), 3)
    np.testing.assert_array_equal(image[:, :9], np.round(np.clip(gt, 0, 1) * 255))


def test_viridis_table_and_colormap_match_matplotlib():
    lut = matplotlib.colormaps["viridis"](np.linspace(0, 1, 256))[:, :3]
    assert np.abs(tv.VIRIDIS / 255.0 - lut).max() <= 1 / 255
    x = np.random.default_rng(1).uniform(-3, 5, (7, 11))
    x[0, 0], x[1, 1] = x.min() - 1, x.max() + 1        # the ends of the range
    norm = matplotlib.colors.Normalize(vmin=x.min(), vmax=x.max())
    want = matplotlib.colormaps["viridis"](norm(x), bytes=True)[..., :3]
    got = tv.colormap(x)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("max_points", [20000, 50])
def test_voxel_selection_is_jax_scatter(tmp_path, monkeypatch, max_points):
    from mpl_toolkits.mplot3d.axes3d import Axes3D
    calls = []
    scatter = Axes3D.scatter
    monkeypatch.setattr(Axes3D, "scatter", lambda self, *a, **kw: (
        calls.append((a, kw)), scatter(self, *a, **kw))[1])
    rng = np.random.default_rng(2)
    grid = np.zeros((12, 12, 12, 10), np.float32)
    grid[..., 3:6] = rng.uniform(-1.3, 1.3, (12, 12, 12, 3))
    grid[..., -1] = rng.uniform(0, 1, (12, 12, 12)) > 0.6
    gt_a, pred_a = np.array([3, 4, 5]), np.array([7, 1, 2])
    jv.visualize_voxel_grid(grid, gt_a, pred_a, save_path=str(tmp_path / "j.png"),
                            max_points=max_points)
    idx, rgb = tv.voxel_points(grid, max_points)
    (xs, ys, zs), kw = calls[0]
    np.testing.assert_array_equal(np.stack([xs, ys, zs], -1), idx)
    np.testing.assert_array_equal(kw["c"], rgb)
    assert len(idx) == min(max_points, int((grid[..., -1] > 0.5).sum()))
    for (a, kw), want in zip(calls[1:], (gt_a, pred_a)):
        np.testing.assert_array_equal(np.array(a), want)
    image = tv.visualize_voxel_grid(grid, gt_a, pred_a, save_path=str(tmp_path / "t.png"),
                                    max_points=max_points)
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")), image)
    s = 256 // 12                                  # pixels a voxel
    assert image.shape == (12 * s, 3 * 12 * s + 2 * tv.GAP, 3)
    # the voxel nearest the viewer on top: two voxels of one (x, y) column
    g2 = np.zeros((12, 12, 12, 10), np.float32)
    g2[1, 10, 3, 3:6], g2[1, 10, 3, -1] = (1.0, -1.0, -1.0), 1.0     # red, z = 3
    g2[1, 10, 1, 3:6], g2[1, 10, 1, -1] = (-1.0, -1.0, 1.0), 1.0     # blue, z = 1
    im2 = tv.visualize_voxel_grid(g2)
    np.testing.assert_array_equal(im2[(11 - 10) * s + 1, 1 * s + 1], [255, 0, 0])
    np.testing.assert_array_equal(im2[0, 0], [255, 255, 255])
    # the marks: lime at the gt action's centre in the view along z
    np.testing.assert_array_equal(image[(11 - 4) * s + s // 2, 3 * s + s // 2], [0, 255, 0])


def test_png_text_chunks_round_trip(tmp_path):
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    write_png(str(tmp_path / "a.png"), img, text={"PSNR": "31.25", "Panels": "gt render"})
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    assert read_png_text(str(tmp_path / "a.png")) == {"PSNR": "31.25", "Panels": "gt render"}
    with pytest.raises(ValueError, match="keyword"):
        write_png(str(tmp_path / "b.png"), img, text={"": "x"})


def test_a_failed_write_raises(tmp_path):
    gt, rgb, depth, embed = _views()
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        tv.save_render_panel(str(tmp_path / "file" / "p.png"), gt, rgb, depth, embed)


def test_render_eval_writes_the_jax_panel(tmp_path):
    """NerfActTrainer.render_eval with save_dir writes render_{step:06d}.png
    (gt, render, depth, embed) with the eval's PSNR."""
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.render import RendererConfig
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    model = dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
                 cross_dim_head=8, latent_dim_head=8, latent_heads=2, voxel_patch_size=5,
                 final_dim=8, lang_emb_dim=16, lang_max_seq_len=4, input_encoder="unet",
                 return_voxel_feat=True)
    cfg = NerfActConfig(
        peract=PerActConfig(model=PerceiverConfig(**model),
                            voxelizer=VoxelizerSpec(voxel_size=10, feature_size=3,
                                                    max_num_coords=2000)),
        renderer=RendererConfig(image_width=10, image_height=8, n_coarse=4, n_fine=2,
                                n_fine_depth=1, field=NerfFieldConfig(
                                    d_latent=8, d_embed=4, d_hidden=16, n_blocks=2,
                                    combine_layer=1)))
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    out = tmp_path / "panels"
    m = tr.render_eval(state, 7, save_dir=str(out))
    assert sorted(os.listdir(out)) == ["render_000007.png"]
    png = str(out / "render_000007.png")
    assert read_png_text(png) == {"Panels": "gt render depth embed",
                                  "PSNR": f"{m['eval_psnr']:.2f}"}
    assert read_png(png).shape == (8, 4 * 10 + 3 * tv.GAP, 3)
    with pytest.raises(OSError):
        tr.render_eval(state, 8, save_dir=png)       # a file where the dir should be
