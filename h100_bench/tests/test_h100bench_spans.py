"""The readers of the program's spans (`core/spans.py` and the render and
train host, launch and sync metrics) on a hand-built trace and the span
record of tiny CPU frames and joint steps run under a CPU profiler, as the
traced run takes them: a unit before the windows, the CUDA-only window's
units, then the CPU and CUDA window's."""
from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100_bench.core import manifest as mf
from h100_bench.core import spans
from h100_bench.core.trace import Trace
from h100_bench.core.window import LayerContext

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
# device ops by name -> (seconds, count): 12 host syncs among 41 ops
KERNELS = {"void resnetfc_wgmma<false, 256>": (0.02, 20),
           "Memcpy HtoD (Pageable -> Device)": (0.001, 9),
           "Memcpy DtoH (Device -> Pageable)": (0.001, 3),
           "Memcpy HtoD (Pinned -> Device)": (0.001, 4),
           "Memset (Device)": (0.001, 5)}
OPS, SYNCS = 41, 12
WINDOW, HOST = 2, 1      # units of the CUDA-only window, then of the CPU and CUDA one


def _trace(on_device=True):
    return Trace(window_s=1.0, busy_s=0.5, kernels=dict(KERNELS), ranges={}, gaps=[],
                 on_device=on_device)


def _ctx(on_device=True, units=WINDOW, host_units=HOST):
    return LayerContext(_trace(on_device), None, list(range(units)), _trace(on_device),
                        list(range(host_units)))


def _traced(run):
    """One unit before the windows, WINDOW units in one profiled window, HOST
    in another, each under a CPU profiler; the record of their spans."""
    from real_robot_nerf_actor_tpu_torch.utils import profiling
    with profiling.collect() as rec:
        for n in (1, WINDOW, HOST):
            with profile(activities=[ProfilerActivity.CPU]):
                for _ in range(n):
                    run()
    return rec


def _program_holds(monkeypatch, rec):
    """The program's record, as the readers find it, is `rec`."""
    from real_robot_nerf_actor_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "record", lambda: rec)


@pytest.fixture(scope="module")
def frames():
    from real_robot_nerf_actor_tpu_torch.data.synthetic import _look_at
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig
    from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, RendererConfig
    field = NerfFieldConfig(d_latent=8, d_embed=16, d_hidden=32, n_blocks=2, combine_layer=1,
                            mask_outside=True, coord_bounds=BOUNDS)
    cfg = RendererConfig(field=field, image_width=16, image_height=16, n_coarse=6, n_fine=4,
                         n_fine_depth=0, sampling_mode="occupancy", occ_pool=2, occ_probes=8,
                         use_ray_plan=True, render_tile=32)
    rend = NeuralRenderer(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    vox = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 8, 8, 8))
                           .astype(np.float32))
    occ_in = torch.zeros(8, 8, 8)
    occ_in[2:6, 2:6, 1:3] = 1.0
    occ = rend.prepare_occupancy(occ_in)
    center = np.array([0.35, 0.2, 0.1], np.float32)
    pose = _look_at(center + np.array([0.9, -0.75, 0.85], np.float32), center)[None]
    plan = rend.plan_rays(occ, pose, 15.2)
    rec = _traced(lambda: rend.render_image(vox, pose, 15.2, occ=occ, plan=plan,
                                            generator=torch.Generator().manual_seed(2)))
    return rec, plan.idx.numel() // 32


@pytest.fixture(scope="module")
def steps():
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.render import RendererConfig
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig
    model = PerceiverConfig(depth=1, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
                            cross_dim_head=8, latent_dim_head=8, latent_heads=2,
                            voxel_patch_size=5, final_dim=8, lang_emb_dim=16,
                            lang_max_seq_len=4, input_encoder="unet", return_voxel_feat=True)
    field = NerfFieldConfig(d_latent=8, d_embed=4, d_hidden=16, n_blocks=2, combine_layer=1,
                            coord_bounds=BOUNDS)
    cfg = NerfActConfig(
        peract=PerActConfig(model=model, voxelizer=VoxelizerSpec(voxel_size=10, feature_size=3,
                                                                 max_num_coords=512),
                            coord_bounds=BOUNDS,
                            train=TrainConfig(num_steps=1, optim=OptimConfig(lr=1e-3))),
        renderer=RendererConfig(field=field, image_width=8, image_height=8, n_coarse=6,
                                n_fine=4, n_fine_depth=2, ray_chunk_size=8, fused_gather=True))
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = next(tr.synthetic_data(batch_size=1, seed=0))
    return _traced(lambda: tr.train_step(state, batch, torch.Generator().manual_seed(1)))


def _read(name, ctx):
    return mf.load_reader(name)(ctx)


def _within(rec, units, name):
    """Spans named `name` that start inside one of `units`, by time."""
    bounds = [rec.span(u)[3:] for u in units]
    return [i for i, n, _, _, start, _ in rec.spans()
            if n == name and any(a <= start <= b for a, b in bounds)]


def test_the_cuda_only_windows_units_are_chosen(monkeypatch, frames, steps):
    rec, _ = frames
    f = rec.closed("render.frame")
    assert len(f) == 1 + WINDOW + HOST
    _program_holds(monkeypatch, rec)
    assert spans.window(_ctx(), "render.frame").units == f[1:1 + WINDOW]
    s = steps.closed("train_step")
    assert len(s) == 1 + WINDOW + HOST
    _program_holds(monkeypatch, steps)
    assert spans.window(_ctx(), "train_step").units == s[1:1 + WINDOW]


def test_render_readers(monkeypatch, frames):
    rec, n_tiles = frames
    _program_holds(monkeypatch, rec)
    ctx = _ctx()
    window = rec.closed("render.frame")[1:1 + WINDOW]
    tiles = _within(rec, window, "render.tile")
    assert len(tiles) == WINDOW * n_tiles
    ms = [rec.ms(i) for i in tiles]
    assert _read("render.tile_host_ms", ctx) == pytest.approx(statistics.median(ms))
    field = sum(rec.ms(i) for i in _within(rec, window, "render.field"))
    assert _read("render.field_host_ms", ctx) == pytest.approx(field / len(tiles))
    assert 0 < _read("render.field_host_ms", ctx) < sum(ms) / len(tiles)
    assert _read("render.launches_per_tile", ctx) == pytest.approx(OPS / len(tiles))
    assert _read("render.host_syncs_per_tile", ctx) == pytest.approx(SYNCS / len(tiles))


def test_train_readers(monkeypatch, steps):
    _program_holds(monkeypatch, steps)
    ctx = _ctx()
    window = steps.closed("train_step")[1:1 + WINDOW]
    opt = [steps.ms(i) for i in _within(steps, window, "train_step.optimizer")]
    assert len(opt) == WINDOW
    assert _read("train.optimizer_host_ms", ctx) == pytest.approx(statistics.median(opt))
    assert _read("train.launches_per_step", ctx) == pytest.approx(OPS / WINDOW)
    assert _read("train.host_syncs_per_step", ctx) == pytest.approx(SYNCS / WINDOW)


NAMES = ["render.tile_host_ms", "render.field_host_ms", "render.launches_per_tile",
         "render.host_syncs_per_tile", "train.optimizer_host_ms", "train.launches_per_step",
         "train.host_syncs_per_step"]


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_raises_on_too_few_units_and_is_none_off_the_device(monkeypatch, frames,
                                                                       steps, name):
    _program_holds(monkeypatch, frames[0] if name.startswith("render") else steps)
    with pytest.raises(RuntimeError, match="spans where the traced windows ran"):
        _read(name, _ctx(units=3 + WINDOW))
    assert _read(name, _ctx(on_device=False)) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_a_span_record_reads_none(monkeypatch, name):
    from real_robot_nerf_actor_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "record")
    assert _read(name, _ctx()) is None


def test_the_readers_read_a_record_that_let_spans_go(monkeypatch):
    """The program's record lives as long as the process and every profiler
    session feeds it: when it fills it lets its oldest spans go, so the
    readers still find the windows' units, the newest; after `clear()` they
    raise until the windows have run again."""
    from real_robot_nerf_actor_tpu_torch.utils import named_scope, profiling
    monkeypatch.setattr(profiling, "CAP", 64)
    rec = profiling.record()

    def frames(n, tiles):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                with named_scope("render.frame"):
                    for _ in range(tiles):
                        with named_scope("render.tile"):
                            pass

    def windows():
        frames(WINDOW, 2)
        frames(HOST, 5)
        ctx = _ctx()
        assert spans.count(spans.window(ctx, "render.frame"), "render.tile") == 2 * WINDOW
        assert _read("render.launches_per_tile", ctx) == pytest.approx(OPS / (2 * WINDOW))
        assert _read("render.tile_host_ms", ctx) > 0

    frames(40, 3)              # 160 older spans: the record fills and lets go
    assert rec.first > 0 and len(rec) <= 64
    windows()
    rec.clear()
    with pytest.raises(RuntimeError, match="spans where the traced windows ran"):
        _read("render.launches_per_tile", _ctx())
    windows()
    rec.clear()


def test_the_manifest_lists_each_reader_in_its_cell():
    b = mf.load_manifest()
    cells = {"render": "serve.render.cam480", "train": "nerfact.train"}
    for m in b["per_layer"]:
        if m["name"] in NAMES:
            assert m["workloads"] == [cells[m["name"].split(".")[0]]]
    assert {m["name"] for m in b["per_layer"]} >= set(NAMES)
