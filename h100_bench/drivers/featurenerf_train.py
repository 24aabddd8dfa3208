"""Cell driver: FeatureNeRF pretraining, `FeatureNerfTrainer.train_step` of
the port, closed loop, one scene a step.

Set-up raytraces the traffic's posed scenes (core/posed_views.py), dumps
the teacher's features of every view with the port's DINO ViT on seeded
weights (`load_teacher` and `extract_teacher_features` at --pca 0, what
`dump_teacher_features` writes into a scene file), and stages images,
poses, focal, features and bboxes on the device once. A step then draws a
scene and its source views with numpy, as the trainer's `scene_data` does,
and its pixel and sampler draws on the device; the trainer's
`_sample_pixels` takes the pixels inside the view's bbox. The state is
built as `make_trainer` builds it (`PixelNerfNet`, `Optimizer` of the
file's optim), on the benchmark's weights. The checked steps' losses, the
first gradient as the optimizer holds it after step one and each leaf's
change over the checked steps are what `check` holds against the
reference; the same state then trains on in the window."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100_bench.core import posed_views, traffic
from h100_bench.core.gaps import leaf_norm_gap, moving_leaves, relative_gap
from h100_bench.core.window import phase
from h100_bench.reference import featurenerf_train as ref

ENCODER = {"stage_features": (64, 64, 128, 256), "blocks_per_stage": 2}   # the port's default


def model_ops(program: dict, view, views: int, src_views: float) -> Dict[str, float]:
    """A step's fp32 model operations (2 a multiply-add), forward and
    backward, from the widths: the encoder's convs and its stage maps'
    resizes on `src_views` source views of `view` (H, W); the field's
    products (the input layer, the latent injections, the blocks' two
    products each, the head) on the coarse pass's rays x n_coarse points and
    the fine pass's rays x (n_coarse + n_fine); the 3 x 3 rotations of the
    points and directions into the sources' frames and of every view's
    rays. The backward takes each product's weight gradient, and its data
    gradient where the input carries one: not the stem's (the image), not
    the field's input layer's (the positional code), not the rotations'."""
    m, r = program.get("model", {}), program.get("renderer", {})
    enc = dict(ENCODER, **m.get("encoder", {}))
    f = list(enc["stage_features"])
    h, w = view
    ns = src_views
    macs = 0.0      # forward multiply-adds; backward ones counted into `back`
    back = 0.0

    def conv(cin, cout, k, hw, first=False):
        nonlocal macs, back
        n = hw[0] * hw[1] * cin * cout * k * k * ns
        macs += n
        back += n if first else 2 * n

    def down(n):     # a k3/s2/p1 or k1/s2 conv, a k3/s2/p1 max pool, k7/s2/p3
        return (n[0] + 1) // 2, (n[1] + 1) // 2

    hw = down((h, w))
    conv(3, f[0], 7, hw, first=True)
    maps = [(hw, f[0])]
    hw = down(hw)
    cin = f[0]
    for si, feat in enumerate(f[1:], start=1):
        for bi in range(enc["blocks_per_stage"]):
            stride = bi == 0 and si > 1
            out = down(hw) if stride else hw
            conv(cin, feat, 3, out)
            conv(feat, feat, 3, out)
            if cin != feat or stride:
                conv(cin, feat, 1, out)
            hw, cin = out, feat
        maps.append((hw, feat))
    target = maps[enc.get("upsample_to_stage", 0)][0]
    for (mh, mw), c in maps:      # the resize along H, then along W; data gradient only
        n = 0
        if mh != target[0]:
            n += mw * c * mh * target[0]
        if mw != target[1]:
            n += target[0] * c * mw * target[1]
        macs += n * ns
        back += n * ns

    hid, nb = m.get("d_hidden", 512), m.get("n_blocks", 5)
    comb = m.get("combine_layer", 3)
    d_latent = sum(f)
    nf = m.get("num_freqs", 6)
    viewdirs = m.get("use_viewdirs", True)
    d_in = 3 + 6 * nf + (3 if viewdirs else 0)
    coord = m.get("regress_coord", False) or program.get("lambda_coord", 0.0) > 0
    d_out = 4 + m.get("d_embed", 384) + (3 if coord else 0)
    rays = program.get("ray_batch_size", 512)
    nc, nfine = r.get("n_coarse", 64), r.get("n_fine", 32)
    for k in ((nc, nc + nfine) if nfine > 0 else (nc,)):
        p = rays * k
        rows = p * ns
        macs += rows * d_in * hid
        back += rows * d_in * hid
        for i in range(nb):
            per = rows if (ns == 1 or i < comb) else p
            if i < comb:
                macs += rows * d_latent * hid
                back += 2 * rows * d_latent * hid
            macs += 2 * per * hid * hid
            back += 4 * per * hid * hid
        macs += p * hid * d_out
        back += 2 * p * hid * d_out
        macs += rows * 9 * (2 if viewdirs else 1)
    macs += views * h * w * 9
    return {"float32": 2.0 * (macs + back)}


class Cell:
    def __init__(self, spec: dict, seed: int, device):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.program = self.config["program"]
        self.seed, self.device = seed, torch.device(device)

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfNet
        from real_robot_nerf_actor_tpu_torch.train.featurenerf import (
            FeatureNerfConfig, FeatureNerfTrainer)
        from real_robot_nerf_actor_tpu_torch.train.trainer import Optimizer, TrainState
        from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

        t, p, dev = self.traffic, self.program, self.device
        self.tr = FeatureNerfTrainer(from_dict(FeatureNerfConfig, p), device=dev)
        cfg = self.tr.cfg
        with phase("scenes"):
            host = posed_views.posed_scenes(t, self.seed)
        hit = np.concatenate([s["depth"][np.isfinite(s["depth"])] for s in host])
        if hit.min() < cfg.z_near or hit.max() > cfg.z_far:
            raise ValueError(f"the scenes' depths {hit.min():.3f}-{hit.max():.3f} m leave the "
                             f"configuration's band {cfg.z_near}-{cfg.z_far} m")
        with phase("teacher", dev):
            feats = self._teacher([s["images"] for s in host])
        with phase("stage", dev):
            self.pool = [{"images": torch.as_tensor(s["images"], device=dev),
                          "poses": torch.as_tensor(s["poses"], device=dev),
                          "focal": torch.tensor(float(t["focal"]), device=dev),
                          "features": torch.as_tensor(fe, device=dev),
                          "bbox": torch.as_tensor(s["bbox"], device=dev)}
                         for s, fe in zip(host, feats)]
        # the scene and source views of a step, drawn as scene_data draws them
        self.rng = np.random.default_rng([self.seed, 5])
        self.gen = traffic.generator(self.seed, traffic.DRAWS, dev)
        with phase("weights", dev):
            with torch.device(dev):
                net = PixelNerfNet(cfg.model)
            net.load_state_dict(ref.initial_state(p, self.seed, dev))
            self.state = TrainState(step=0, module=net,
                                    optimizer=Optimizer(cfg.train.optim, net.named_parameters()))
        with phase("checked_steps", dev):
            self._checked_steps(t["checked_steps"])
        with phase("warmup_steps", dev):
            for _ in range(t["warmup_steps"]):
                self.step()

    def _teacher(self, images: List[np.ndarray]) -> List[np.ndarray]:
        """Each scene's teacher features (V, H/patch, W/patch, D) at the
        teacher's full width."""
        from real_robot_nerf_actor_tpu_torch.models.vit import ViTConfig
        from real_robot_nerf_actor_tpu_torch.train.distill2d import (
            extract_teacher_features, load_teacher)

        te = self.traffic["teacher"]
        h, w = self.traffic["view"]
        vit = load_teacher(ViTConfig(patch_size=te["patch"], embed_dim=te["embed_dim"],
                                     depth=te["depth"], image_size=max(h, w)),
                           self.device, seed=self.seed * 4 + traffic.INPUTS)
        out = [extract_teacher_features(vit, im, te["feature_layer"], te["attn_layer"])[0]
               for im in images]
        del vit
        return out

    def feed(self):
        """The next step's batch and draws."""
        b = self.pool[int(self.rng.integers(0, len(self.pool)))]
        nv, h, w, _ = b["images"].shape
        nviews = self.tr.cfg.nviews
        ns = min(int(nviews[self.rng.integers(0, len(nviews))]), nv)
        batch = dict(b, src_ord=torch.as_tensor(self.rng.choice(nv, size=ns, replace=False),
                                                dtype=torch.long, device=self.device))
        return batch, draws(self.gen, self.tr.cfg, nv, h, w)

    def step(self) -> int:
        batch, d = self.feed()
        self.state, self.metrics = self.tr.train_step(self.state, batch, draws=d["pixels"],
                                                      render_draws=d["render"])
        return 1

    def _checked_steps(self, n: int) -> None:
        named = list(self.state.module.named_parameters())
        start = {k: v.detach().clone() for k, v in named}
        self.checked: dict = {"batches": [], "draws": [], "losses": []}
        for i in range(n):
            batch, d = self.feed()
            self.checked["batches"].append(batch)
            self.checked["draws"].append(d)
            self.state, metrics = self.tr.train_step(self.state, batch, draws=d["pixels"],
                                                     render_draws=d["render"])
            self.checked["losses"].append(float(metrics["loss"]))
            if i == 0:
                opt = self.state.optimizer.adamw
                b1 = opt.param_groups[0]["betas"][0]
                self.checked["grad"] = {
                    k: (float(opt.state[v]["exp_avg"].norm()) / (1 - b1)
                        if "exp_avg" in opt.state.get(v, {}) else 0.0)
                    for k, v in named}
        self.checked["change"] = {k: float((v.detach() - start[k]).norm()) for k, v in named}

    # -------------------------------------------------------------- window
    def end_to_end(self, record) -> Dict[str, float]:
        return {"train_samples_per_s": record.rate()}

    def attempted_failed(self, record):
        return len(record.work), 0

    def window_closed(self) -> None:
        pass

    def free(self) -> None:
        self.state = self.tr = self.metrics = None

    # ------------------------------------------------------------ per layer
    def unit_work(self, i: int) -> dict:
        """No hand-written kernel runs on this path."""
        return {}

    def unit_model_ops(self, i: int) -> Dict[str, float]:
        """A step's model operations (`model_ops`), with the mean number of
        source views a step draws."""
        t, nv = self.traffic, self.program.get("nviews", [1])
        return model_ops(self.program, t["view"], t["views"],
                         sum(min(k, t["views"]) for k in nv) / len(nv))

    # --------------------------------------------------------------- check
    def check(self) -> List[tuple]:
        """(name, value, limit) of each number compared with the reference."""
        got = self.checked
        want = ref.steps(self.program, ref.initial_state(self.program, self.seed, self.device),
                         got["batches"], got["draws"], self.device)
        return compare(got, want, self.traffic["limits"])


def draws(g: torch.Generator, cfg, nv: int, h: int, w: int) -> dict:
    """One step's draws on the generator's device: each ray's view and
    pixel (v, y, x) and its bbox uniforms (u_bbox), then the renderer's
    sample draws."""
    dev, r, rc = g.device, cfg.ray_batch_size, cfg.renderer
    nf = rc.n_fine - rc.n_fine_depth
    pixels = {"v": torch.randint(0, nv, (r,), generator=g, device=dev),
              "y": torch.randint(0, h, (r,), generator=g, device=dev),
              "x": torch.randint(0, w, (r,), generator=g, device=dev),
              "u_bbox": torch.rand((r, 2), generator=g, device=dev)}
    render = {"coarse_u": torch.rand((r, rc.n_coarse), generator=g, device=dev),
              "fine_u": torch.rand((r, nf), generator=g, device=dev),
              "fine_jitter": torch.rand((r, nf), generator=g, device=dev),
              "fine_depth_eps": torch.randn((r, rc.n_fine_depth), generator=g, device=dev)}
    return {"pixels": pixels, "render": render}


def compare(got: dict, want: dict, limits: dict) -> List[tuple]:
    """Each step's loss (relative gap); the first gradient by the median
    leaf; each moving leaf's change by the worst."""
    keep = moving_leaves(want["grad"])
    return [("loss_gap", relative_gap(got["losses"], want["losses"]), limits["loss_gap"]),
            ("grad_gap", leaf_norm_gap(got["grad"], want["grad"], quantile=0.5),
             limits["grad_gap"]),
            ("change_gap", leaf_norm_gap(got["change"], want["change"], keep),
             limits["change_gap"])]


def readings(cell: Cell, seconds: float) -> dict:
    """The numbers `check` compares, read for setting its limits: the
    program's (the set-up's checked steps), the control's (the reference
    in TF32) and each planted fault's (the reference with the fault), each
    against the reference."""
    got = cell.checked
    cell.free()
    args = (cell.program, ref.initial_state(cell.program, cell.seed, cell.device),
            got["batches"], got["draws"], cell.device)
    want = ref.steps(*args)
    out = {"program": got, "control_tf32": ref.steps(*args, control=True)}
    out.update({f"fault_{f}": ref.steps(*args, fault=f) for f in ref.FAULTS})
    return {k: compare(v, want, cell.traffic["limits"]) for k, v in out.items()}
