"""The port's FeatureNeRF step against the benchmark's plain reference
(`h100_bench/reference/featurenerf_train.py`, on frozen copies of pixelNeRF's
net, encoder, renderer and FeatureNeRF's losses), at a small width on the
CPU: encoder stages (4, 4, 8) of one block, field 16 x 2 blocks combining at
block 1, d_embed 6 with the coord head, 16 rays of 6 + 4 samples (2 around
the coarse depth), 3 posed 16 x 16 views of the benchmark's scenes; the
same seeded weights (`core/weights.py`), bboxes and draws on both sides.

Tolerances (fp32 on one CPU thread, the same operations in the same order
on both sides, so the gaps read 0 here; what they leave room for is a
change of summation order): the loss 1e-6 relative; each gradient 1e-5 of
its tensor's largest |g|; each parameter after AdamW 1e-7 absolute, a
thousandth of the learning rate 1e-4 that bounds a first Adam step. A
planted fault, u and v swapped before the latent lookup, moves the loss by
more than 1e-3 relative here.

And the FeatureNeRF spans: featurenerf.sample, .project, .field and
.composite open once each a field pass (two a step) inside
`profiling.collect()`, and outside it they are the shared null context and
record nothing.
"""
import numpy as np
import pytest
import torch

from h100_bench.core import posed_views
from h100_bench.reference import featurenerf_train as ref
from h100_bench.reference.frozen.train.featurenerf import losses, sample_pixels
from real_robot_nerf_actor_tpu_torch.models import pixelnerf as port_pixelnerf
from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfNet
from real_robot_nerf_actor_tpu_torch.train.featurenerf import (
    FeatureNerfConfig, FeatureNerfTrainer)
from real_robot_nerf_actor_tpu_torch.train.trainer import Optimizer, TrainState
from real_robot_nerf_actor_tpu_torch.utils import profiling
from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

PROGRAM = {"model": {"d_embed": 6, "d_hidden": 16, "n_blocks": 2, "combine_layer": 1,
                     "regress_coord": True,
                     "encoder": {"stage_features": [4, 4, 8], "blocks_per_stage": 1}},
           "renderer": {"n_coarse": 6, "n_fine": 4, "n_fine_depth": 2, "white_bkgd": False},
           "ray_batch_size": 16, "z_near": 0.5, "z_far": 1.8, "lambda_embed": 0.1,
           "lambda_attn": 0.0, "lambda_coord": 0.25, "nviews": [1],
           "train": {"optim": {"lr": 1.0e-4}}}
SCENES = {"scenes": 1, "views": 3, "view": [16, 16], "focal": 15.2, "scene_points": 200,
          "bounds": [-0.1, -0.3, -0.2, 0.8, 0.7, 0.7],
          "orbit": {"center": [0.35, 0.2, 0.1], "offset": [0.6, -0.5, 0.55]}}
SEED = 2 ** 31 + 5
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-7


@pytest.fixture(scope="module")
def setting():
    torch.manual_seed(0)
    sc = posed_views.posed_scenes(SCENES, SEED)[0]
    g = torch.Generator().manual_seed(SEED)
    batch = {"images": torch.as_tensor(sc["images"]), "poses": torch.as_tensor(sc["poses"]),
             "focal": torch.tensor(SCENES["focal"]), "bbox": torch.as_tensor(sc["bbox"]),
             "features": torch.randn((3, 2, 2, 6), generator=g), "src_ord": torch.tensor([1])}
    tr = FeatureNerfTrainer(from_dict(FeatureNerfConfig, PROGRAM), device="cpu")
    pixels = {"v": torch.randint(0, 3, (16,), generator=g),
              "y": torch.randint(0, 16, (16,), generator=g),
              "x": torch.randint(0, 16, (16,), generator=g),
              "u_bbox": torch.rand((16, 2), generator=g)}
    render = {"coarse_u": torch.rand((16, 6), generator=g),
              "fine_u": torch.rand((16, 2), generator=g),
              "fine_jitter": torch.rand((16, 2), generator=g),
              "fine_depth_eps": torch.randn((16, 2), generator=g)}
    return tr, batch, {"pixels": pixels, "render": render}


def _port_step(tr, batch, d):
    net = PixelNerfNet(tr.cfg.model)
    net.load_state_dict(ref.initial_state(PROGRAM, SEED, "cpu"))
    state = TrainState(step=0, module=net,
                       optimizer=Optimizer(tr.cfg.train.optim, net.named_parameters()))
    grads = {}

    def keep():      # the gradients as the backward leaves them, before AdamW
        grads.update({n: p.grad.clone() for n, p in net.named_parameters()})
    inner = state.optimizer.step
    state.optimizer.step = lambda: (keep(), inner())[1]
    state, metrics = tr.train_step(state, batch, draws=d["pixels"], render_draws=d["render"])
    return float(metrics["loss"]), grads, dict(net.named_parameters())


def _reference_step(batch, d):
    cfg = ref.plain_config(PROGRAM)
    net = ref.plain_module(PROGRAM)
    net.load_state_dict(ref.initial_state(PROGRAM, SEED, "cpu"))
    v, y, x = sample_pixels(cfg, batch["bbox"], 0, d["pixels"])
    loss = losses(net, cfg, batch, v, y, x, batch["src_ord"], d["render"])
    loss.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    opt = ref.AdamW([p for p in net.parameters()], ref.optim(PROGRAM))
    opt.step()
    return float(loss.detach()), grads, dict(net.named_parameters())


def test_train_step_matches_the_plain_reference(setting):
    tr, batch, d = setting
    loss, grads, params = _port_step(tr, batch, d)
    want_loss, want_grads, want_params = _reference_step(batch, d)
    assert np.isfinite(loss) and loss > 0
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    assert set(grads) == set(want_grads)
    for n, g in want_grads.items():
        scale = float(g.abs().max())
        assert scale > 0, n
        assert float((grads[n] - g).abs().max()) <= GRAD_TOL * scale, n
        assert float((params[n].detach() - want_params[n].detach()).abs().max()) <= PARAM_TOL, n


def test_a_planted_uv_swap_fails_the_comparison(setting, monkeypatch):
    tr, batch, d = setting
    inner = port_pixelnerf.bilinear_sample_2d
    monkeypatch.setattr(port_pixelnerf, "bilinear_sample_2d",
                        lambda feat, uv: inner(feat, uv.flip(-1)))
    loss, _, _ = _port_step(tr, batch, d)
    want_loss, _, _ = _reference_step(batch, d)
    assert abs(loss - want_loss) > 1e-3 * abs(want_loss)


SPANS = ("featurenerf.sample", "featurenerf.project", "featurenerf.field",
         "featurenerf.composite")


def test_the_spans_open_once_a_field_pass_and_cost_nothing_outside(setting):
    tr, batch, d = setting
    with profiling.collect() as rec:
        _port_step(tr, batch, d)
    calls = {k: v["calls"] for k, v in rec.summary().items()}
    assert {s: calls.get(s) for s in SPANS} == dict.fromkeys(SPANS, 2)
    assert calls["featurenerf.render"] == 1
    # nested under the render span, on the step's thread
    names = {i: n for i, n, *_ in rec.spans()}
    for i, n, parent, *_ in rec.spans():
        if n in SPANS:
            while names.get(parent) not in (None, "featurenerf.render"):
                parent = rec.parent[parent - rec.first]
            assert names.get(parent) == "featurenerf.render", n
    before = len(profiling.record())
    assert all(profiling.named_scope(s) is profiling._OFF for s in SPANS)
    _port_step(tr, batch, d)
    assert len(profiling.record()) == before


def test_the_scenes_lie_in_the_configuration_s_depth_band():
    sc = posed_views.posed_scenes(dict(SCENES, scenes=2), 7)
    for s in sc:
        hit = s["depth"][np.isfinite(s["depth"])]
        assert hit.size and PROGRAM["z_near"] < hit.min() and hit.max() < PROGRAM["z_far"]
        c0, r0, c1, r1 = s["bbox"].T
        assert (c0 <= c1).all() and (r0 <= r1).all() and (c1 < 16).all() and (r1 < 16).all()
