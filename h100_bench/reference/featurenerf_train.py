"""Reference of drivers/featurenerf_train.py: FeatureNeRF pretraining's step
in plain PyTorch on the frozen copies of pixelNeRF's net, encoder, renderer
and FeatureNeRF's losses (`frozen/models/pixelnerf.py`, `encoder2d.py`,
`render/pixelnerf_renderer.py`, `train/featurenerf.py`), in fp32 with TF32
off: the source views encoded in inference mode, the rays of the step's
pixels rendered coarse then fine, the loss, one backward and the AdamW
update of the configuration's optimizer (`nerfact_train.AdamW`). It takes
the benchmark's weights, scenes and draws, and nothing the program made.

It follows pixelNeRF (arXiv:2012.02190) and FeatureNeRF (arXiv:2303.12786)
as the source repository's robo_dino_real.conf runs them, with these
departures: the encoder has `blocks_per_stage` blocks a stage (2) where
pixelNeRF's ResNet-34 has 3, 4 and 6; its stage maps are brought to the
stem's resolution by jax.image.resize's bilinear; the teacher map is
sampled with each axis normalised by its own size (the source divides both
by (H, W), the same for square views); the optimizer is the port's AdamW
(decoupled decay 1e-6, a step with a non-finite gradient skipped)."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

from h100_bench.core import traffic
from h100_bench.core.tf32 import TF32
from h100_bench.core.weights import seeded_state
from h100_bench.reference.frozen.models.pixelnerf import PixelNerfNet
from h100_bench.reference.frozen.train.featurenerf import (
    FeatureNerfConfig, losses, sample_pixels)
from h100_bench.reference.frozen.utils_config import from_dict
from h100_bench.reference.nerfact_train import AdamW

# the port's OptimConfig defaults that the file leaves as they are
OPTIM = {"lr": 1e-4, "weight_decay": 1e-6, "name": "adamw", "grad_clip": 0.0,
         "accum_steps": 1, "schedule": "constant", "lr_decay_rate": 0.0}
FAULTS = ("swap_uv", "other_view", "targets_xy_swapped")


def plain_config(program: dict) -> FeatureNerfConfig:
    """The frozen FeatureNerfConfig of the program's dict; lambda_coord > 0
    turns the coord head on, as the port's trainer does."""
    cfg = from_dict(FeatureNerfConfig, {k: v for k, v in program.items() if k != "train"})
    if cfg.lambda_coord > 0 and not cfg.model.regress_coord:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, regress_coord=True))
    return cfg


def optim(program: dict) -> dict:
    o = dict(OPTIM, **program.get("train", {}).get("optim", {}))
    if o["name"] != "adamw" or o["grad_clip"] or o["accum_steps"] != 1 or o["lr_decay_rate"]:
        raise ValueError(f"the reference steps plain AdamW at a constant rate, not {o}")
    return o


def plain_module(program: dict) -> PixelNerfNet:
    return PixelNerfNet(plain_config(program).model)


def initial_state(program: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's weights (core/weights.py), in the field's layout."""
    net = plain_module(program).to(device)
    return seeded_state(net, traffic.generator(seed, traffic.WEIGHTS, device))


def steps(program: dict, sd: Dict[str, torch.Tensor], batches: List[dict], draws: List[dict],
          device, control: bool = False, fault: Optional[str] = None) -> dict:
    """The reference's steps from `sd` on the batches and draws (pixels:
    v, y, x, u_bbox; render: coarse_u, fine_u, fine_jitter,
    fine_depth_eps): each step's loss, the first step's gradient norm by
    leaf, and each leaf's change over all the steps. control: the products
    in TF32; fault: a planted fault (FAULTS)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = plain_config(program)
    net = plain_module(program).to(device)
    net.load_state_dict(sd)
    named = list(net.named_parameters())
    opt = AdamW([p for _, p in named], optim(program))
    start = {n: p.detach().clone() for n, p in named}
    out: dict = {"losses": [], "grad": {}}
    for i, (batch, d) in enumerate(zip(batches, draws)):
        net.zero_grad(set_to_none=True)
        with TF32(device) if control else contextlib.nullcontext():
            v, y, x = sample_pixels(cfg, batch.get("bbox"), i, d["pixels"])
            loss = losses(net, cfg, batch, v, y, x, batch["src_ord"], d["render"], fault)
            loss.backward()
        out["losses"].append(float(loss.detach()))
        if i == 0:
            out["grad"] = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                           for n, p in named}
        opt.step()
    out["change"] = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    return out
