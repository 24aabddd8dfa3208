"""The cell featurenerf.train on the CPU at a tiny width (encoder stages
(4, 4, 8) of one block, field 16 x 2 blocks combining at block 1, d_embed 12,
16 rays of 6 + 4 samples, 2 scenes of 3 views at 16 x 16, a ViT teacher 12
wide and 12 deep): the run against its reference and the result line's
schema, the TF32 control and the planted faults coming out not correct (in
the reference, and under the timed path), the model-operation count against
a hand count and against the reference's products, the configuration
against configs/featurenerf.yaml, and the readers on a hand-built trace
with and without the program's new spans. The limits are the cell's own:
the tiny width reads its program at 0 to 1.5e-7 here, its control at 3e-4
and more in loss."""
from __future__ import annotations

import json

import pytest
import torch

from h100_bench.core import counts
from h100_bench.core import manifest as mf
from h100_bench.core.trace import Trace
from h100_bench.core.window import LayerContext
from h100_bench.run import run_cell

from .conftest import REPO, make_tiny_root

SEED = 2 ** 31 + 99
CELL = "featurenerf.train"
CONFIG = "h100_bench/configs/featurenerf/featurenerf-robo-dino.json"
TINY_MODEL = {"d_embed": 12, "d_hidden": 16, "n_blocks": 2, "combine_layer": 1,
              "encoder": {"stage_features": [4, 4, 8], "blocks_per_stage": 1}}
TINY_TRAFFIC = {"scenes": 2, "views": 3, "view": [16, 16], "focal": 15.2, "scene_points": 200,
                "teacher": {"patch": 8, "embed_dim": 12, "depth": 12, "feature_layer": 9,
                            "attn_layer": 11}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = make_tiny_root(tmp_path_factory.mktemp("tiny_featurenerf"))
    p = dest / CONFIG
    c = json.loads(p.read_text())
    c["program"]["model"].update(TINY_MODEL)
    c["program"]["renderer"].update(n_coarse=6, n_fine=4, n_fine_depth=2)
    c["program"]["ray_batch_size"] = 16
    p.write_text(json.dumps(c))
    p = dest / "h100_bench" / "traffic" / f"{CELL}.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), **TINY_TRAFFIC)))
    return dest


def _spec(root):
    return mf.cell_spec(mf.load_manifest(root / "BENCHMARK.json"), CELL, root)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct_and_its_line_keeps_the_schema(root, trace):
    r = run_cell(CELL, SEED, 1.0, trace, torch.device("cpu"), root=root)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    spec = _spec(root)
    if trace:
        assert r["metrics"] == {} and set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]} \
            == {"train_samples_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(r)


def test_control_and_planted_faults_fail_the_check(root):
    drv = mf.load_driver("featurenerf_train", root / "h100_bench")
    cell = drv.Cell(_spec(root), SEED, torch.device("cpu"))
    cell.setup()
    r = drv.readings(cell, 0.0)
    assert all(v <= lim for _, v, lim in r["program"])
    for kind in ("control_tf32", "fault_swap_uv", "fault_other_view",
                 "fault_targets_xy_swapped"):
        assert any(v > lim for _, v, lim in r[kind]), kind


def _swap_uv(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.models import pixelnerf

    inner = pixelnerf.bilinear_sample_2d
    monkeypatch.setattr(pixelnerf, "bilinear_sample_2d", lambda f, uv: inner(f, uv.flip(-1)))


def _other_view(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import FeatureNerfTrainer

    inner = FeatureNerfTrainer.compute_losses

    def compute_losses(self, net, batch, v, y, x, src_ord, *a, **k):
        images = batch["images"][(src_ord + 1) % batch["images"].shape[0]]
        encode = FeatureNerfTrainer.encode
        self.encode = lambda n, _, poses, focal: encode(self, n, images, poses, focal)
        try:
            return inner(self, net, batch, v, y, x, src_ord, *a, **k)
        finally:
            del self.encode
    monkeypatch.setattr(FeatureNerfTrainer, "compute_losses", compute_losses)


def _targets_swapped(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.train import featurenerf

    inner = featurenerf._sample_view_maps
    monkeypatch.setattr(featurenerf, "_sample_view_maps",
                        lambda maps, v, y, x, shape: inner(maps, v, x, y, shape))


@pytest.mark.parametrize("fault", [_swap_uv, _other_view, _targets_swapped])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    r = run_cell(CELL, SEED, 0.5, False, torch.device("cpu"), root=root)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


TINY_PROGRAM = {"model": {"d_embed": 6, "d_hidden": 16, "n_blocks": 2, "combine_layer": 1,
                          "regress_coord": True,
                          "encoder": {"stage_features": [4, 4, 8], "blocks_per_stage": 1}},
                "renderer": {"n_coarse": 6, "n_fine": 4, "n_fine_depth": 2},
                "ray_batch_size": 16, "z_near": 0.5, "z_far": 1.8, "lambda_coord": 0.25,
                "lambda_attn": 0.0, "nviews": [1]}


def test_model_ops_against_a_hand_count():
    """Multiply-adds of one step on one 16 x 16 source view of 3 views.
    Encoder forward: stem 8x8 px x 3 x 4 x 49 = 37632; stage 1 at 4x4: two
    3x3 convs 4 -> 4, 2 x 2304; stage 2 at 2x2: 3x3 4 -> 8 1152, 3x3 8 -> 8
    2304, the 1x1 shortcut 128; the resizes to 8x8 (along H, then W):
    stage 1 4*4*4*8 + 8*4*4*8 = 1536, stage 2 2*8*2*8 + 8*8*2*8 = 1280.
    Backward: every weight gradient, and the data gradient of all but the
    stem; the resizes' data gradients. Field a point (d_in 42, d_latent 16,
    hidden 16, d_out 6 + 4 + 3 = 13): forward 42*16 + 16*16 (block 0's
    latent) + 4 * 16*16 + 16*13 + 18 (two 3x3 rotations) = 2178; backward
    42*16 + 2 * (256 + 1024 + 208) = 3648; points 16 x 6 + 16 x 10 = 256.
    The rays of 3 views: 3 * 256 * 9."""
    drv = mf.load_driver("featurenerf_train")
    enc_fwd = 37632 + 2 * 2304 + 1152 + 2304 + 128 + 1536 + 1280
    enc_back = 37632 + 2 * (2 * 2304 + 1152 + 2304 + 128) + 1536 + 1280
    macs = enc_fwd + enc_back + 256 * (2178 + 3648) + 3 * 256 * 9
    assert drv.model_ops(TINY_PROGRAM, (16, 16), 3, 1) == {"float32": 2.0 * macs}


def test_model_ops_against_the_reference_s_products():
    """Every product the reference's step dispatches, forward and backward
    (torch's flop counter), equals the count."""
    from h100_bench.core.scenes import orbit_poses
    from h100_bench.reference import featurenerf_train as ref
    from h100_bench.reference.frozen.train.featurenerf import losses, sample_pixels

    drv = mf.load_driver("featurenerf_train")
    for ns in (1, 2):
        cfg = ref.plain_config(TINY_PROGRAM)
        net = ref.plain_module(TINY_PROGRAM)
        net.load_state_dict(ref.initial_state(TINY_PROGRAM, 1, "cpu"))
        g = torch.Generator().manual_seed(0)
        batch = {"images": torch.rand(3, 16, 16, 3, generator=g),
                 "features": torch.randn(3, 2, 2, 6, generator=g), "focal": torch.tensor(15.2),
                 "poses": torch.as_tensor(orbit_poses(3, offset=(0.6, -0.5, 0.55))),
                 "src_ord": torch.arange(ns)}
        d = drv.draws(g, cfg, 3, 16, 16)

        def run():
            v, y, x = sample_pixels(cfg, None, 0, d["pixels"])
            losses(net, cfg, batch, v, y, x, batch["src_ord"], d["render"]).backward()
        assert counts.model_ops(run) == drv.model_ops(TINY_PROGRAM, (16, 16), 3, ns), ns


def test_the_configuration_is_the_file_s():
    yaml = pytest.importorskip("yaml")
    c = json.loads((REPO / CONFIG).read_text())
    assert c["program"] == yaml.safe_load((REPO / "configs" / "featurenerf.yaml").read_text())
    assert c["reduced"] == [] and c["kernels"] == []
    t = json.loads((REPO / "h100_bench" / "traffic" / f"{CELL}.json").read_text())
    assert set(t["limits"]) == set(t["limits_why"])
    assert t["teacher"]["embed_dim"] == c["program"]["model"]["d_embed"]


RANGES = {"featurenerf.encode": (0.002, 2), "featurenerf.project": (0.006, 4),
          "featurenerf.field": (0.04, 4), "featurenerf.backward": (0.08, 2)}


@pytest.mark.parametrize("spans_in_program", [False, True])
def test_readers_on_a_hand_built_trace(spans_in_program):
    """Two steps in each window: the ranges' device seconds over the steps;
    a program without the new spans (the parent's) leaves their readers
    silent and the others reading."""
    ranges = dict(RANGES)
    if not spans_in_program:
        del ranges["featurenerf.project"], ranges["featurenerf.field"]
    kernels = {"sgemm": (0.1, 40), "Memcpy HtoD (Pageable -> Device)": (0.001, 2),
               "Memcpy DtoH (Device -> Pageable)": (0.001, 4)}
    tr = Trace(window_s=0.2, busy_s=0.15, kernels=kernels, ranges=ranges, gaps=[])

    class Cell:
        def unit_model_ops(self, i):
            return {"float32": 1.34e12}
    ctx = LayerContext(tr, Cell(), [0, 1], tr, [0, 1])
    got = {m: mf.load_reader(m)(ctx) for m in (
        "featurenerf.encode_ms", "featurenerf.project_ms", "featurenerf.field_ms",
        "featurenerf.backward_ms", "featurenerf.launches_per_step",
        "featurenerf.host_syncs_per_step", "device.idle_share.featurenerf", "mfu.featurenerf")}
    assert got["featurenerf.encode_ms"] == pytest.approx(1.0)
    assert got["featurenerf.backward_ms"] == pytest.approx(40.0)
    if spans_in_program:
        assert got["featurenerf.project_ms"] == pytest.approx(3.0)
        assert got["featurenerf.field_ms"] == pytest.approx(20.0)
    else:
        assert got["featurenerf.project_ms"] is None and got["featurenerf.field_ms"] is None
    assert got["featurenerf.launches_per_step"] == 23
    assert got["featurenerf.host_syncs_per_step"] == 3
    assert got["device.idle_share.featurenerf"] == pytest.approx(25.0)
    assert got["mfu.featurenerf"] == pytest.approx(100.0 * 2 * 1.34e12 / 67e12 / 0.2)
