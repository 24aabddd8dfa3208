"""PerAct BC training: SE(3) aug -> voxelize -> PerceiverIO -> cross-entropy
losses -> AdamW (counterpart of the JAX package's `train/peract.py`).

`PerActConfig` has the JAX package's fields and meanings, so
`configs/peract.yaml` loads into both packages. `PerActTrainer.train_step`
follows the JAX step line for line, eagerly: per-sample shifts, the next
keyframe as the action and the current one as the proprio position,
voxelization, the forward, `bc_losses`, backward and the optimizer step.
With `conv_backend: pallas` on a CUDA device the `final` conv runs the k3
kernel forward and its VJP backward (ops/conv3d_cuda.py). The flash
attention and spatial-stats kernels have no backward, so their knobs stay
off in training (their wrappers refuse grad). The step runs the network
with train=True, so a UNet encoder's BatchNorm normalises with the batch
statistics and updates its running ones (the JAX `_forward` under
`mutable=["batch_stats"]`); `predict` reads them.

Entry points run on CUDA unless the caller passes device="cpu"; without a
CUDA device they raise rather than fall back.

    python -m real_robot_nerf_actor_tpu_torch.train.peract --steps 100
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.data.replay import PointCloudSample, pad_point_cloud
from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    make_synthetic_demo, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig, PerceiverIO
from real_robot_nerf_actor_tpu_torch.ops.action_codec import DiscreteAction, discretize_action
from real_robot_nerf_actor_tpu_torch.ops.geometry import point_to_voxel_index
from real_robot_nerf_actor_tpu_torch.ops.se3_aug import apply_se3_augmentation
from real_robot_nerf_actor_tpu_torch.ops.voxelize import VoxelizerSpec, voxelize
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import (
    Optimizer, TrainConfig, Trainer, TrainState)
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope


def iter_transitions(rng: np.random.Generator, train_demos, num_transitions,
                     sample_mode: str = "uniform") -> Iterator[Tuple[int, int]]:
    """Yield (demo, keyframe) pairs forever. "uniform": i.i.d. draws;
    "demo_cycle": one random demo's whole transition set, shuffled, before
    the next demo is drawn. num_transitions: demo -> keyframes - 1."""
    if sample_mode not in ("uniform", "demo_cycle"):
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    cycle: list = []
    while True:
        if sample_mode == "demo_cycle":
            if not cycle:
                d = train_demos[int(rng.integers(0, len(train_demos)))]
                ks = rng.permutation(num_transitions(d))
                cycle = [(d, int(k)) for k in ks]
            yield cycle.pop()
        else:
            d = train_demos[int(rng.integers(0, len(train_demos)))]
            yield d, int(rng.integers(0, num_transitions(d)))


@dataclasses.dataclass(frozen=True)
class PerActConfig:
    model: PerceiverConfig = dataclasses.field(default_factory=PerceiverConfig)
    voxelizer: VoxelizerSpec = dataclasses.field(default_factory=VoxelizerSpec)
    coord_bounds: Tuple[float, ...] = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
    rotation_resolution: float = 5.0
    trans_aug_range: Tuple[float, float, float] = (0.125, 0.05, 0.05)
    use_se3_aug: bool = True
    lambda_aux_trans: float = 0.5    # weight of the aux coarse-trans CE
    trans_label_smooth: float = 0.0  # epsilon of the 27-neighbour trans smoothing
    z_loss: float = 0.0              # weight of mean(logsumexp^2) on the CE heads
    se3_symmetric_clamp: bool = True
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's softmax_cross_entropy_with_integer_labels: logsumexp minus
    the label's logit. A label of -1 (the codec's rotation bin below 0)
    wraps to the last class, as JAX's indexing wraps it."""
    labels = labels.long()
    labels = torch.where(labels < 0, labels + logits.shape[-1], labels)
    return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[:, None])[:, 0]


def _flat(trans: torch.Tensor, v: int) -> torch.Tensor:
    t = trans.long()
    return (t[:, 0] * v + t[:, 1]) * v + t[:, 2]


def bc_losses(q_trans: torch.Tensor, q_rot_grip: torch.Tensor,
              q_collision: torch.Tensor, action: DiscreteAction, voxel_size: int,
              num_rotation_classes: int = 72, q_trans_aux: Optional[torch.Tensor] = None,
              patch_size: int = 5, lambda_aux: float = 0.5, trans_smooth: float = 0.0,
              z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Integer-label cross-entropy on every head against the discrete
    expert action: trans (V^3-way), rot x/y/z (R-way), grip and collision
    (2-way), summed per sample and averaged over the batch.

    trans_smooth > 0 spreads epsilon of the trans target over the
    separable [0.25, 0.5, 0.25]^3 neighbourhood (indices clipped at the
    grid's edge); z_loss > 0 adds z_loss * mean(logsumexp^2) over the
    trans and rot/grip softmaxes; q_trans_aux adds lambda_aux * CE of the
    coarse (V/patch)^3 head against the down-binned target."""
    b = q_trans.shape[0]
    r = num_rotation_classes
    v = voxel_size
    logits = q_trans.reshape(b, -1)
    flat_idx = _flat(action.trans, v)
    if trans_smooth > 0.0:
        logp = torch.log_softmax(logits, dim=-1)
        rows = torch.arange(b, device=logits.device)
        center = -logp[rows, flat_idx]
        w1 = (0.25, 0.5, 0.25)
        nb = torch.zeros((b,), device=logits.device)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    w = w1[dx + 1] * w1[dy + 1] * w1[dz + 1]
                    off = torch.tensor([dx, dy, dz], device=logits.device)
                    t = torch.clamp(action.trans.long() + off, 0, v - 1)
                    nb = nb - w * logp[rows, _flat(t, v)]
        trans_loss = (1.0 - trans_smooth) * center + trans_smooth * nb
    else:
        trans_loss = _ce(logits, flat_idx)
    rg = action.rot_grip
    rot_grip_loss = (_ce(q_rot_grip[:, 0 * r:1 * r], rg[:, 0])
                     + _ce(q_rot_grip[:, 1 * r:2 * r], rg[:, 1])
                     + _ce(q_rot_grip[:, 2 * r:3 * r], rg[:, 2])
                     + _ce(q_rot_grip[:, 3 * r:], rg[:, 3]))
    collision_loss = _ce(q_collision, action.collision[:, 0])
    total = torch.mean(trans_loss + rot_grip_loss + collision_loss)
    metrics = {
        "loss_trans": torch.mean(trans_loss),
        "loss_rot_grip": torch.mean(rot_grip_loss),
        "loss_collision": torch.mean(collision_loss),
    }
    if z_loss > 0.0:
        lse = torch.logsumexp
        z = (torch.mean(lse(logits, dim=-1) ** 2)
             + torch.mean(sum(lse(q_rot_grip[:, i * r:(i + 1) * r], dim=-1) ** 2
                              for i in range(3))
                          + lse(q_rot_grip[:, 3 * r:], dim=-1) ** 2))
        total = total + z_loss * z
        metrics["loss_z"] = z_loss * z
    if q_trans_aux is not None:
        s = v // patch_size
        aux_loss = torch.mean(_ce(q_trans_aux, _flat(action.trans.long() // patch_size, s)))
        total = total + lambda_aux * aux_loss
        metrics["loss_trans_aux"] = aux_loss
    metrics["loss"] = total
    return total, metrics


class PerActTrainer:
    """The PerAct BC train step and its synthetic data pipeline on
    `device` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, cfg: PerActConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bounds = torch.tensor(cfg.coord_bounds, dtype=torch.float32, device=self.device)
        self.trans_aug_range = torch.tensor(cfg.trans_aug_range, dtype=torch.float32,
                                            device=self.device)

    # ------------------------------------------------------------- state
    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """A network with weights drawn as flax draws them (from
        `generator`), on the trainer's device, and its optimizer."""
        net = PerceiverIO.initialized(self.cfg.model, generator).to(self.device).train()
        return TrainState(step=0, module=net,
                          optimizer=Optimizer(self.cfg.train.optim, net.named_parameters()))

    # -------------------------------------------------------------- step
    def _forward_bc(self, net, batch, generator=None, draws=None):
        """SE(3) aug, voxelization, the forward in train mode and
        `bc_losses`: (network outputs, the aug (None without it), the BC
        loss, its metrics). Each phase is a span: train_step.augment,
        .voxelize, .policy and .bc_loss."""
        c = self.cfg
        v = c.model.voxel_size
        points = batch["points"]
        aug = None
        with named_scope("train_step.augment"):
            if c.use_se3_aug:
                if draws is None:
                    gen_dev = generator.device if generator is not None else "cpu"
                    draws = torch.rand((points.shape[0], 3), generator=generator,
                                       device=gen_dev) * 2.0 - 1.0
                aug = apply_se3_augmentation(points, batch["kf_xyz"], self.bounds,
                                             self.trans_aug_range, v,
                                             symmetric_clamp=c.se3_symmetric_clamp, u=draws)
                points = aug.pcd
                action_trans = aug.action_trans[:, 1]   # next keyframe
                proprio_trans = aug.action_trans[:, 0]  # current keyframe
            else:
                idx = point_to_voxel_index(batch["kf_xyz"], v, self.bounds)
                action_trans, proprio_trans = idx[:, 1], idx[:, 0]
        with named_scope("train_step.voxelize"):
            proprio = torch.cat([proprio_trans.float(), batch["proprio"][:, 3:]], dim=-1)
            vox = voxelize(points, batch["colors"], self.bounds, c.voxelizer,
                           valid=batch["valid"])
        with named_scope("train_step.policy"):
            out = net(vox, proprio, batch["lang"], train=True)
        with named_scope("train_step.bc_loss"):
            action = DiscreteAction(trans=action_trans, rot_grip=batch["rot_grip"],
                                    collision=batch["collision"])
            total, metrics = bc_losses(
                out[0], out[1], out[2], action, v, c.model.num_rotation_classes,
                q_trans_aux=out[-1] if c.model.aux_trans_head else None,
                patch_size=c.model.voxel_patch_size, lambda_aux=c.lambda_aux_trans,
                trans_smooth=c.trans_label_smooth, z_loss=c.z_loss)
        return out, aug, total, metrics

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on `batch` (all leading dim B, on the device):
          points (B,N,3), colors (B,N,3), valid (B,N), proprio (B,7),
          lang (B,77,512), kf_xyz (B,2,3) current + next keyframe positions,
          rot_grip (B,4) int, collision (B,1) int.
        draws (B, 3) in [-1, 1) are the SE(3) shifts' uniforms; without
        them they come from `generator`. Updates state.module and
        state.optimizer in place; returns the state and the loss metrics
        (device tensors). The parameters' .grad hold this step's gradients
        afterwards. Spans (`utils/profiling`): train_step around the step,
        in it train_step.forward (the spans of `_forward_bc`), .backward
        and .optimizer."""
        with named_scope("train_step"):
            with named_scope("train_step.forward"):
                state.module.zero_grad(set_to_none=True)
                total, metrics = self._forward_bc(state.module, batch, generator, draws)[2:]
            with named_scope("train_step.backward"):
                total.backward()
            with named_scope("train_step.optimizer"):
                state.optimizer.step()
            state.step += 1
            return state, {k: m.detach() for k, m in metrics.items()}

    # ------------------------------------------------------------ inference
    def predict(self, state: TrainState, vox, proprio, lang):
        with torch.no_grad():
            return state.module(vox, proprio, lang)

    # ---------------------------------------------------------------- data
    def synthetic_data(self, batch_size: int = 1, seed: int = 0,
                       lang_embs: Optional[np.ndarray] = None, n_tasks: int = 1,
                       n_kitchens: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches over synthetic keyframe demos, drawn as the JAX package
        draws them (the same numpy draws, so the same batches). Each
        kitchen's padded cloud is put on the device once: the per-step
        clouds come from this small set, and uploading 220000 points every
        step would dominate the host loop."""
        c = self.cfg
        dev = self.device
        rng = np.random.default_rng(seed)
        cpu_bounds = self.bounds.cpu()
        combos = []
        for kitchen in range(n_kitchens):
            scene = make_synthetic_scene(seed=seed + 101 * kitchen)
            cloud = tuple(torch.as_tensor(a).to(dev) for a in pad_point_cloud(
                PointCloudSample(scene.points, scene.colors), c.voxelizer.max_num_coords))
            for task in range(n_tasks):
                demo = make_synthetic_demo(scene, seed=seed + 7 * task)
                le = (lang_embs if lang_embs is not None else
                      np.random.default_rng(1000 + task).standard_normal(
                          (c.model.lang_max_seq_len, c.model.lang_emb_dim)
                      ).astype(np.float32))
                nk = demo.num_keyframes
                disc = discretize_action(
                    torch.as_tensor(demo.xyz), torch.as_tensor(demo.rotation),
                    torch.as_tensor(demo.gripper_open), torch.ones((nk,)),
                    cpu_bounds, c.model.voxel_size, c.rotation_resolution)
                combos.append((cloud, demo, le, disc.rot_grip.numpy(),
                               disc.collision.numpy()))
        keys = ("points", "colors", "valid", "proprio", "lang", "kf_xyz", "rot_grip",
                "collision")
        while True:
            out = {k: [] for k in keys}
            for _ in range(batch_size):
                cloud, demo, le, rg_all, coll_all = combos[int(rng.integers(0, len(combos)))]
                i = int(rng.integers(0, demo.num_keyframes - 1))
                for k, a in zip(("points", "colors", "valid"), cloud):
                    out[k].append(a)
                out["proprio"].append(torch.as_tensor(np.concatenate(
                    [np.zeros(3, np.float32), np.asarray(rg_all[i], np.float32)])))
                out["lang"].append(torch.as_tensor(le))
                out["kf_xyz"].append(torch.as_tensor(np.stack([demo.xyz[i],
                                                               demo.xyz[i + 1]])))
                out["rot_grip"].append(torch.as_tensor(rg_all[i + 1]))
                out["collision"].append(torch.as_tensor(coll_all[i + 1]))
            yield {k: torch.stack(v).to(dev) for k, v in out.items()}

    def replay_data(self, root: str, n_demos: int, batch_size: int = 1, seed: int = 0,
                    lang_embs: Optional[np.ndarray] = None, with_views: bool = False,
                    exclude_demos: Tuple[int, ...] = (), sample_mode: str = "uniform"
                    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches from recorded demos (`data/replay.ReplaySource`'s layout):
        pick (demo, keyframe k), observe pcd{k}, supervise with keyframe
        k+1's action. with_views adds each keyframe's ground-truth view
        (gt_rgb, gt_pose, focal, and gt_embed / gt_depth where recorded).
        exclude_demos holds demo ids out of training. sample_mode "uniform"
        draws (demo, keyframe) i.i.d.; "demo_cycle" emits one demo's whole
        transition set, shuffled, before it draws the next demo (see
        iter_transitions). See multi_replay_data."""
        entry = {"root": root, "n_demos": n_demos, "lang": lang_embs,
                 "exclude_demos": tuple(exclude_demos)}
        return self.multi_replay_data([entry], batch_size, seed, with_views=with_views,
                                      sample_mode=sample_mode)

    def multi_replay_data(self, entries, batch_size: int = 1, seed: int = 0,
                          with_views: bool = False, sample_mode: str = "uniform"
                          ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches drawn across several recorded kitchen-task directories.
        entries: dicts {root, n_demos, lang (77, D) or None, exclude_demos};
        each carries its own language embedding, calibration and views.

        The draws are the JAX package's: one np.random.default_rng(seed),
        (demo, keyframe) by iter_transitions, then, with views, the camera
        of each sample; so both packages give the same batches. Every cloud,
        view and label is staged on the device once, when the first batch
        is asked for (the labels computed there, as the JAX package computes
        them on its device); a batch is then stacked from them on the
        device."""
        from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource

        c = self.cfg
        dev = self.device
        rng = np.random.default_rng(seed)
        srcs = [ReplaySource(e["root"], e["n_demos"]) for e in entries]
        if with_views:
            for e, src in zip(entries, srcs):
                if not src.has_views:
                    raise ValueError(f"{e['root']} has no ground-truth views "
                                     "(real*/rgb*.png): train PerAct only")
        zero_lang = np.zeros((c.model.lang_max_seq_len, c.model.lang_emb_dim), np.float32)
        langs = [torch.as_tensor(e.get("lang") if e.get("lang") is not None
                                 else zero_lang, dtype=torch.float32).to(dev)
                 for e in entries]

        units = []     # (entry, demo) training units
        clouds = {}    # (e, d, k) -> (points, colors, valid) on the device
        views = {}     # (e, d, k, v) -> {gt_rgb[, gt_embed][, gt_depth]} on the device
        disc = {}      # (e, d) -> (rot_grip (K, 4), collision (K, 1)) numpy
        gt_poses = {}  # e -> (n_views, 4, 4) on the device
        focals = {}
        for ei, (e, src) in enumerate(zip(entries, srcs)):
            exclude = set(e.get("exclude_demos", ()))
            train_demos = [d for d in range(e["n_demos"]) if d not in exclude]
            if not train_demos:
                raise ValueError(f"exclude_demos removed every demo of {e['root']}")
            for d in train_demos:
                units.append((ei, d))
                demo = src.demos[d]
                nk = demo.num_keyframes
                dd = discretize_action(
                    torch.as_tensor(demo.xyz, device=dev),
                    torch.as_tensor(demo.rotation, device=dev),
                    torch.as_tensor(demo.gripper_open, device=dev),
                    torch.ones((nk,), device=dev), self.bounds, c.model.voxel_size,
                    c.rotation_resolution)
                disc[(ei, d)] = (dd.rot_grip.cpu().numpy(), dd.collision.cpu().numpy())
                for k in range(nk):
                    clouds[(ei, d, k)] = tuple(
                        torch.as_tensor(a).to(dev) for a in pad_point_cloud(
                            src.pointcloud(d, k), c.voxelizer.max_num_coords))
                    if with_views:
                        for vi in range(src.n_train_views):
                            v = src.view(d, k, vi)
                            views[(ei, d, k, vi)] = {
                                key: torch.as_tensor(v[name]).to(dev)
                                for key, name in (("gt_rgb", "rgb"), ("gt_embed", "embed"),
                                                  ("gt_depth", "depth")) if name in v}
            if with_views:
                gt_poses[ei] = torch.as_tensor(np.stack(
                    [src.train_pose(vi) for vi in range(src.n_train_views)])).to(dev)
                focals[ei] = float(src.focal)

        picks = iter_transitions(rng, units,
                                 lambda u: srcs[u[0]].num_keyframes(u[1]) - 1, sample_mode)
        while True:
            host = {k: [] for k in ("proprio", "kf_xyz", "rot_grip", "collision")}
            staged = {k: [] for k in ("points", "colors", "valid", "lang")}
            vout: Dict[str, list] = {}
            focal_out = []
            for _ in range(batch_size):
                (ei, d), k = next(picks)
                rg_all, coll_all = disc[(ei, d)]
                for key, a in zip(("points", "colors", "valid"), clouds[(ei, d, k)]):
                    staged[key].append(a)
                staged["lang"].append(langs[ei])
                host["proprio"].append(np.concatenate(
                    [np.zeros(3, np.float32), np.asarray(rg_all[k], np.float32)]))
                xyz = srcs[ei].demos[d].xyz
                host["kf_xyz"].append(np.stack([xyz[k], xyz[k + 1]]))
                host["rot_grip"].append(rg_all[k + 1])
                host["collision"].append(coll_all[k + 1])
                if with_views:
                    vi = int(rng.integers(0, srcs[ei].n_train_views))
                    for key, a in views[(ei, d, k, vi)].items():
                        vout.setdefault(key, []).append(a)
                    vout.setdefault("gt_pose", []).append(gt_poses[ei][vi])
                    focal_out.append(focals[ei])
            batch = {k: torch.stack(v) for k, v in staged.items()}
            batch.update({k: torch.as_tensor(np.stack(v)).to(dev) for k, v in host.items()})
            batch.update({k: torch.stack(v) for k, v in vout.items()})
            if with_views:
                batch["focal"] = torch.tensor(focal_out, dtype=torch.float32, device=dev)
            yield batch

    def make_trainer(self, data: Optional[Iterator] = None) -> Trainer:
        return Trainer(self.cfg.train, self.train_step, data or self.synthetic_data(),
                       self.init_state)


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """PerAct BC training (the counterpart of scripts/train_peract.py): on
    recorded demos with --data-root, or across a multi-kitchen dataset with
    --multi-root, else on the bundled synthetic scene. Configs are JSON
    (YAML where PyYAML is installed) with dot-path overrides."""
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", default=None, help="JSON/YAML PerActConfig")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="dot-path config overrides, e.g. train.optim.lr=3e-4")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-root", default=None,
                    help="recorded demos: {d}_xarm_position.txt + real{d}/pcd{k}.ply")
    ap.add_argument("--multi-root", default=None,
                    help="multi-kitchen dataset: manifest.json + lang_embs.npz + k{i}_t{j}/")
    ap.add_argument("--n-demos", type=int, default=5)
    args = ap.parse_args(argv)

    cfg = load_config(PerActConfig, args.config, args.override)
    tcfg = cfg.train
    if args.steps is not None:
        tcfg = dataclasses.replace(tcfg, num_steps=args.steps)
    tcfg = dataclasses.replace(tcfg, ckpt_dir=args.ckpt_dir or tcfg.ckpt_dir,
                               log_dir=args.log_dir or tcfg.log_dir)
    cfg = dataclasses.replace(cfg, train=tcfg)
    tr = PerActTrainer(cfg, device=args.device)
    if args.multi_root:
        from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
        data = tr.multi_replay_data(load_multitask_entries(args.multi_root), args.batch_size)
    elif args.data_root:
        data = tr.replay_data(args.data_root, args.n_demos, args.batch_size)
    else:
        data = tr.synthetic_data(batch_size=args.batch_size)
    return tr.make_trainer(data).run(resume=not args.no_resume)


if __name__ == "__main__":
    main()
