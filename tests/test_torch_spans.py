"""The port's span primitive (`utils/profiling.named_scope`, `collect`,
`record`) and the spans of the render tile and the train step, on the CPU:
off it records nothing and opens no profiler range; on, its times agree
with the profiler's own, parents link per thread (a VJP's span included),
a frame and a joint step give the spans their docstrings name, `summary()`
adds up, and a full record lets its oldest spans go and counts them."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from real_robot_nerf_actor_tpu_torch.data.synthetic import _look_at
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig, blocks
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
from real_robot_nerf_actor_tpu_torch.ops.grid_sample import (
    expand_corners_to, grid_sample_3d_fastbwd)
from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, RendererConfig
from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig
from real_robot_nerf_actor_tpu_torch.utils import named_scope, profiling

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
TILE_PHASES = ("render.sample", "render.field", "render.composite", "render.resample")


def _children(rec, i):
    return [j for j, _, parent, *_ in rec.spans() if parent == i]


def _names(rec, idx):
    return [rec.span(j)[0] for j in idx]


def _annotations(prof):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened with collection off")
    monkeypatch.setattr(profiling, "_range_bindings", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    before = len(profiling.record())
    scope = named_scope("off")
    assert scope is named_scope("another")     # the one shared null context
    with scope:
        with named_scope("nested"):
            torch.ones(4).sum()
    assert len(profiling.record()) == before


def test_span_times_agree_with_the_profilers_annotations():
    """The span's start and end against the user annotation of the same
    range, within 100 us (the span is stamped just before the range's enter
    and just after its exit). Warm-up spans first, in a session of their own and at the
    start of the measured one: a process's first ranges run its profiler's
    lazy set-up, a session's first range sets up the thread's event queue."""
    rec = profiling.record()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with named_scope("spans.warmup"):
                x @ x
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with named_scope("spans.warmup"):
            pass
        first = rec.first + len(rec)
        for _ in range(10):
            with named_scope("spans.clock"):
                for _ in range(20):
                    x @ x
                with named_scope("spans.clock.inner"):
                    torch.ones(64).sum()
    ann = _annotations(prof)
    for name in ("spans.clock", "spans.clock.inner"):
        mine = [(a, b) for i, n, _, _, a, b in rec.spans() if i >= first and n == name]
        assert len(mine) == len(ann[name]) == 10
        for (a, b), (c, d) in zip(mine, ann[name]):
            assert abs(a - c) <= 100_000 and abs(b - d) <= 100_000, (name, a - c, b - d)


def test_parents_link_per_thread_and_inside_a_vjp():
    """A span opened in the backward of `_ExpandCorners` and of
    `_FastBwdSample` (CPU tensors: the backward runs on the calling thread)
    is a child of the span around `.backward()`; a span on another thread
    starts its own stack."""
    grid = torch.rand(1, 3, 3, 3, 2, requires_grad=True)
    coords = torch.rand(1, 5, 3) * 2 - 1
    seen = {}

    def other():
        with named_scope("spans.thread"):
            seen["tid"] = threading.get_ident()

    with profiling.collect() as rec:
        with named_scope("spans.step"):
            with named_scope("spans.backward"):
                y = expand_corners_to(grid, torch.float32).sum()
                y = y + grid_sample_3d_fastbwd(grid, coords).sum()
                y.backward()
            t = threading.Thread(target=other)
            t.start()
            t.join()
    idx = {name: i for i, name, *_ in rec.spans()}
    step, bwd = idx["spans.step"], idx["spans.backward"]
    assert rec.span(step)[1] == -1 and rec.span(bwd)[1] == step
    assert sorted(_names(rec, _children(rec, bwd))) == ["backward.expand_corners",
                                                        "backward.grid_sample"]
    thread = rec.span(idx["spans.thread"])
    assert thread[1] == -1 and thread[2] == seen["tid"] != rec.span(step)[2]
    assert all(end is not None and end >= start for *_, start, end in rec.spans())


def _renderer():
    field = NerfFieldConfig(d_latent=8, d_embed=16, d_hidden=32, n_blocks=2, combine_layer=1,
                            mask_outside=True, coord_bounds=BOUNDS)
    cfg = RendererConfig(field=field, image_width=16, image_height=16, n_coarse=6, n_fine=4,
                         n_fine_depth=0, sampling_mode="occupancy", occ_pool=2, occ_probes=8,
                         use_ray_plan=True, render_tile=32)
    return NeuralRenderer(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))


def test_a_planned_frame_gives_a_tile_span_a_tile_with_its_phases():
    rend = _renderer()
    rng = np.random.default_rng(1)
    vox = torch.from_numpy(rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32))
    occ_in = torch.zeros(8, 8, 8)
    occ_in[2:6, 2:6, 1:3] = 1.0
    occ = rend.prepare_occupancy(occ_in)
    center = np.array([0.35, 0.2, 0.1], np.float32)
    pose = _look_at(center + np.array([0.9, -0.75, 0.85], np.float32), center)[None]
    focal = 15.2
    plan = rend.plan_rays(occ, pose, focal)
    n_tiles = plan.idx.numel() // min(rend.cfg.render_tile, plan.idx.numel())
    assert n_tiles >= 2
    with profiling.collect() as rec:
        rend.render_image(vox, pose, focal, generator=torch.Generator().manual_seed(2),
                          occ=occ, plan=plan)
    frames = rec.closed("render.frame")
    assert len(frames) == 1 and rec.span(frames[0])[1] == -1
    top = _names(rec, _children(rec, frames[0]))
    assert top == ["render.rays"] + ["render.tile"] * n_tiles + ["render.scatter"]
    for t in rec.closed("render.tile"):
        phases = _names(rec, _children(rec, t))
        assert set(phases) == set(TILE_PHASES), phases
        assert phases.count("render.field") == 2     # the coarse and the fine pass
    assert rec.first == 0 and len(rec.closed("render.tile")) == n_tiles


def test_a_joint_step_gives_its_phases_and_the_vjp_spans():
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
                                n_fine=4, n_fine_depth=2, ray_chunk_size=8,
                                fused_gather=True))
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = next(tr.synthetic_data(batch_size=1, seed=0))
    with profiling.collect() as rec:
        tr.train_step(state, batch, torch.Generator().manual_seed(1))
    [step] = rec.closed("train_step")
    assert rec.span(step)[1] == -1
    kids = {rec.span(j)[0]: j for j in _children(rec, step)}
    assert list(kids) == ["train_step.forward", "train_step.render", "train_step.backward",
                          "train_step.optimizer"]
    assert set(_names(rec, _children(rec, kids["train_step.forward"]))) == {
        "train_step.augment", "train_step.voxelize", "train_step.policy",
        "train_step.bc_loss"}
    assert _names(rec, _children(rec, kids["train_step.optimizer"])) == [
        "optimizer.finite_check"]
    # the render loss's passes, and the VJP of the corner expansion
    render = set(_names(rec, _children(rec, kids["train_step.render"])))
    assert set(TILE_PHASES) <= render
    # then the fp32 policy's convs (Conv3dWgrad): `final`, up0's two and the
    # UNet's eleven, which autograd reaches last
    convs = [m for m in state.module.modules()
             if isinstance(m, (blocks.Conv3d, blocks.ConvTranspose3d))]
    assert len(convs) == 14
    assert _names(rec, _children(rec, kids["train_step.backward"])) == [
        "backward.expand_corners"] + ["backward.unet_conv"] * 14


def test_summary_self_time_is_the_duration_less_the_childrens():
    with profiling.collect() as rec:
        for _ in range(2):
            with named_scope("spans.outer"):
                time.sleep(0.001)
                with named_scope("spans.inner"):
                    time.sleep(0.002)
                with named_scope("spans.inner"):
                    time.sleep(0.001)
    s = rec.summary()
    outer, inner = rec.closed("spans.outer"), rec.closed("spans.inner")
    assert (s["spans.outer"]["calls"], s["spans.inner"]["calls"]) == (2, 4)
    total = sum(rec.ms(i) for i in outer)
    assert s["spans.outer"]["total_ms"] == pytest.approx(total)
    assert s["spans.outer"]["self_ms"] == pytest.approx(total - sum(rec.ms(i) for i in inner))
    assert s["spans.inner"]["self_ms"] == pytest.approx(s["spans.inner"]["total_ms"])
    assert 1.5 <= s["spans.outer"]["self_ms"] < s["spans.outer"]["total_ms"]


def test_a_full_record_drops_and_counts(monkeypatch):
    """A full record lets its oldest half go and counts it in `first`; the
    held spans keep their indices and parents, and a span still open when
    its slot went closes without a trace."""
    monkeypatch.setattr(profiling, "CAP", 4)
    with profiling.collect() as rec:
        with named_scope("spans.a"):
            for _ in range(5):
                with named_scope("spans.b"):
                    pass
        with named_scope("spans.c"):
            pass
    # a0 b1 b2 b3, full: a0 b1 go (a0 still open); b4 b5, full: b2 b3 go; c6
    assert rec.first == 4 and len(rec) == 3
    assert [i for i, *_ in rec.spans()] == [4, 5, 6]
    assert _names(rec, range(4, 7)) == ["spans.b", "spans.b", "spans.c"]
    assert [rec.span(i)[1] for i in range(4, 7)] == [0, 0, -1]
    assert all(end is not None for *_, end in rec.spans())
    assert rec.closed("spans.a") == [] and rec.summary()["spans.b"]["calls"] == 2
    with pytest.raises(IndexError, match="let go"):
        rec.span(3)
    rec.clear()
    assert (rec.first, len(rec), rec.summary()) == (7, 0, {})
    # a closed block: named_scope is off again
    assert named_scope("spans.after") is named_scope("spans.other")
