"""Each cell end to end on the CPU at a tiny width, on the port's plain
paths: the run against its reference, the result line's schema, the
control failing the check, and the faults a cell can have, planted under
the timed path, coming out not correct. The limits here are the tiny
width's own, set from its readings: the cells' limits are the H100's at the
published widths."""
from __future__ import annotations

import json

import pytest
import torch

from h100_bench.core import manifest as mf
from h100_bench.run import main, run_cell

SEED = 2 ** 31 + 99
TINY_LIMITS = {"nerfact.train": {"loss_gap": 0.005, "grad_gap": 0.05, "change_gap": 0.15},
               "serve.render.cam480": {"rgb_rmse": 0.001, "depth_rel_rmse": 0.15,
                                       "embed_rel_rmse": 0.15}}
CELLS = list(TINY_LIMITS)


@pytest.fixture(scope="module")
def root(tiny_root):
    for name, lim in TINY_LIMITS.items():
        p = tiny_root / "h100_bench" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t["limits"] = lim
        p.write_text(json.dumps(t))
    return tiny_root


def run(root, workload, trace=False, seconds=1.0):
    return run_cell(workload, SEED, seconds, trace, torch.device("cpu"), root=root)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct_and_its_line_keeps_the_schema(root, workload, trace):
    r = run(root, workload, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    spec = mf.cell_spec(mf.load_manifest(root / "BENCHMARK.json"), workload, root)
    if trace:
        # a CPU run reads no device metric
        assert r["metrics"] == {} and set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(TINY_LIMITS[workload])
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(r)


def test_train_control_fails_the_check(root):
    drv = mf.load_driver("nerfact_train", root / "h100_bench")
    spec = mf.cell_spec(mf.load_manifest(root / "BENCHMARK.json"), "nerfact.train", root)
    cell = drv.Cell(spec, SEED, torch.device("cpu"))
    cell.setup()
    r = drv.readings(cell, 0.0)
    assert all(v <= lim for _, v, lim in r["program"])
    assert any(v > lim for _, v, lim in r["control_fp8"])
    assert any(v > lim for _, v, lim in r["fault_half_rays"])


def test_render_control_fails_the_check(root):
    drv = mf.load_driver("serve_render", root / "h100_bench")
    spec = mf.cell_spec(mf.load_manifest(root / "BENCHMARK.json"), "serve.render.cam480", root)
    cell = drv.Cell(spec, SEED, torch.device("cpu"))
    cell.setup()
    r = drv.readings(cell, 1.0)
    assert all(v <= lim for _, v, lim in r["program"])
    for kind in ("control_int4", "fault_half_rays", "fault_channels_swapped"):
        assert any(v > lim for _, v, lim in r[kind]), kind


def _state_unchanged(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer

    def train_step(self, state, batch, generator=None, draws=None, ray_idx=None,
                   render_draws=None):
        with torch.no_grad():
            _, metrics, _ = self.losses(state, batch, generator, draws, ray_idx, render_draws)
        return state, {k: m.detach() for k, m in metrics.items()}
    monkeypatch.setattr(NerfActTrainer, "train_step", train_step)


def _half_rays(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.render.renderer import NeuralRenderer

    inner = NeuralRenderer.rendering_loss

    def rendering_loss(self, *a, ray_idx=None, draws=None, **k):
        half = ray_idx.shape[0] // 2
        return inner(self, *a, ray_idx=ray_idx[:half],
                     draws={n: x[:half] for n, x in draws.items()}, **k)
    monkeypatch.setattr(NeuralRenderer, "rendering_loss", rendering_loss)


def _frame_half(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.render.renderer import NeuralRenderer

    inner = NeuralRenderer.render_image

    def render_image(self, *a, **k):
        rgb, embed, depth = (x.clone() for x in inner(self, *a, **k))
        rgb[::2], embed[::2], depth[::2] = 0, 0, 0
        return rgb, embed, depth
    monkeypatch.setattr(NeuralRenderer, "render_image", render_image)


def _frame_altered(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.render.renderer import NeuralRenderer

    inner = NeuralRenderer.render_image

    def render_image(self, *a, **k):
        rgb, embed, depth = inner(self, *a, **k)
        return rgb.flip(-1), embed, depth
    monkeypatch.setattr(NeuralRenderer, "render_image", render_image)


@pytest.mark.parametrize("workload,fault", [
    ("nerfact.train", _state_unchanged), ("nerfact.train", _half_rays),
    ("serve.render.cam480", _frame_half), ("serve.render.cam480", _frame_altered)])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    r = run(root, workload)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_without_a_card_the_run_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", "nerfact.train", "--seed", "1", "--seconds", "1",
                 "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
