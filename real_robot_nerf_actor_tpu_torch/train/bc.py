"""Behaviour cloning over the representation zoo (counterpart of the JAX
package's `train/bc.py`).

One trainer for every variant of the reference's train_bc*.py, set by
(embedding name, observation mode, policy head):
  - the MLP head (ContinuousPolicy: two relu Dense layers, a tanh Dense to
    the action) on the embedding's features, MSE to the expert actions, one
    Adam step (optax.adam's arithmetic: train/trainer.adam) per batch;
    freeze_encoder=True computes the features without gradient and steps
    the head alone, else the encoder is fine-tuned with it;
  - the diffusion head (rl/diffusion_bc.DiffusionBC) on the features, the
    encoder frozen whatever freeze_encoder says, as in the JAX package.
Fine-tuning trains the encoder's BatchNorm running statistics too: the zoo
runs its encoders on those statistics, and the JAX package differentiates
and Adam-steps its whole `enc_vars`, `batch_stats` included. Here they
become trainable leaves (blocks.train_statistics_) on that path; left
frozen, the port's encoder would drift from JAX's after the first update.

`dataset_from_trajectories` builds (observation, action) pairs from
Trajectory lists, in keyframe mode labelling each keyframe with the motion
toward the next one (simple_motion_planning); `fit` runs epochs over them
in numpy's default_rng(seed) order; `evaluate` runs any gym-style env
object (reset(seed=...) -> (obs, info); step(a) -> (obs, reward,
terminated, truncated, info) with info["success"]). The trainer runs on
CUDA unless the caller passes device="cpu".
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.data.demos import (
    KeyframeBuffer, Trajectory, simple_motion_planning)
from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, init_weights, train_statistics_
from real_robot_nerf_actor_tpu_torch.models.representations import make_embedding
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import adam


class ContinuousPolicy(nn.Module):
    """MLP action head over embedding features."""

    def __init__(self, feat_dim: int, action_dim: int = 4, hidden_dim: int = 256):
        super().__init__()
        self.Dense_0 = Dense(feat_dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        self.Dense_2 = Dense(hidden_dim, action_dim)

    def forward(self, feat):
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(feat))))
        return torch.tanh(self.Dense_2(h))


@dataclasses.dataclass(frozen=True)
class BCConfig:
    embedding: str = "simple"       # representation zoo name
    policy_head: str = "mlp"        # "mlp" | "diffusion"
    task_name: str = "lift"
    obs_mode: str = "image"         # "state" | "image" | "pointcloud"
    action_dim: int = 4
    hidden_dim: int = 256
    lr: float = 3e-4
    batch_size: int = 64
    freeze_encoder: bool = False
    keyframe_mode: bool = False     # keyframe BC + motion interpolation
    image_size: int = 32


class BCTrainer:
    """The zoo encoder's weights come from a generator seeded with (seed,
    crc32(name)) (representations.name_seed), the head's from seed: load
    pretrained or converted weights into `self.encoder` / `self.policy`
    (its `.net` for the diffusion head) before training."""

    def __init__(self, cfg: BCConfig, obs_example, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding = make_embedding(cfg.embedding)
        obs1 = _batch_one(obs_example)
        self.encoder = self.embedding.init(obs1, seed, self.device)
        with torch.no_grad():
            feat_dim = int(self.embedding(obs1).shape[-1])
        if cfg.policy_head == "diffusion":
            from real_robot_nerf_actor_tpu_torch.rl.diffusion_bc import (
                DiffusionBC, DiffusionBCConfig)
            self.policy = DiffusionBC(DiffusionBCConfig(
                obs_dim=feat_dim, action_dim=cfg.action_dim, hidden_dim=cfg.hidden_dim),
                seed=seed, device=self.device)
        else:
            self.policy = init_weights(ContinuousPolicy(feat_dim, cfg.action_dim, cfg.hidden_dim),
                                       torch.Generator().manual_seed(seed)).to(self.device)
            self.optimizer = adam(cfg.lr, self.trainable())
        self._rng = np.random.default_rng(seed)

    def trainable(self) -> List[Tuple[str, torch.Tensor]]:
        """What the MLP head's Adam steps: the head; unless the encoder is
        frozen, also its weights and BatchNorm running statistics."""
        named = [(f"policy.{n}", p) for n, p in self.policy.named_parameters()]
        if not self.cfg.freeze_encoder and self.encoder is not None:
            named += [(f"encoder.{n}", p) for n, p in self.encoder.named_parameters()]
            named += [(f"encoder.{n}", t) for n, t in train_statistics_(self.encoder)]
        return named

    # ----------------------------------------------------------------- API
    def update(self, obs_batch, action_batch, **draws) -> float:
        """One step on a batch; the loss. draws (t, eps) go to the diffusion
        head's update."""
        actions = torch.as_tensor(action_batch, dtype=torch.float32, device=self.device)
        if self.cfg.policy_head == "diffusion":
            with torch.no_grad():
                feat = self.embedding(obs_batch)
            return self.policy.update(feat, actions, **draws)
        for p in self.optimizer.params:
            p.grad = None
        with torch.set_grad_enabled(not self.cfg.freeze_encoder):
            feat = self.embedding(obs_batch)
        loss = torch.mean((self.policy(feat) - actions) ** 2)
        loss.backward()
        self.optimizer.step()
        return loss.item()

    @torch.no_grad()
    def act(self, obs, **draws) -> np.ndarray:
        """The action for one observation (draws x, noise go to the
        diffusion head's sampler)."""
        feat = self.embedding(_batch_one(obs))
        if self.cfg.policy_head == "diffusion":
            return self.policy.sample_action(feat[0], **draws)
        return self.policy(feat)[0].cpu().numpy()

    # ------------------------------------------------------ demo interface
    def dataset_from_trajectories(self, trajs: List[Trajectory]) -> Tuple[list, np.ndarray]:
        if not self.cfg.keyframe_mode:
            obs = [o for t in trajs for o in t.observations]
            return obs, np.stack([a for t in trajs for a in t.actions])
        # keyframe BC: each keyframe's obs labelled with the interpolated
        # motion toward the NEXT keyframe and its gripper state
        buf = KeyframeBuffer()
        for t in trajs:
            buf.add_trajectory(t)
        obs, acts = [], []
        kfs = buf.keyframes
        for i in range(len(kfs) - 1):
            path = simple_motion_planning(kfs[i]["ee_pos"], kfs[i + 1]["ee_pos"], n_steps=1)
            delta = path[0] - kfs[i]["ee_pos"]
            a = np.clip(np.concatenate(
                [delta * 10, [1.0 if kfs[i + 1]["gripper_open"] < 0.5 else -1.0]]), -1, 1)
            obs.append(kfs[i]["obs"])
            acts.append(a.astype(np.float32))
        return obs, np.stack(acts)

    def fit(self, trajs: List[Trajectory], epochs: int = 3) -> List[float]:
        obs, actions = self.dataset_from_trajectories(trajs)
        n = len(obs)
        losses = []
        for _ in range(epochs):
            order = self._rng.permutation(n)
            for s in range(0, n, self.cfg.batch_size):
                idx = order[s:s + self.cfg.batch_size]
                losses.append(self.update(_stack_obs([obs[i] for i in idx]), actions[idx]))
        return losses

    def evaluate(self, env, n_episodes: int = 5, max_steps: int = 40) -> float:
        """Success rate over n_episodes of env (reset seeds 1000, 1001, ...)."""
        succ = 0
        for ep in range(n_episodes):
            obs, _ = env.reset(seed=1000 + ep)
            for _ in range(max_steps):
                obs, _, term, trunc, info = env.step(self.act(obs))
                if info.get("success"):
                    succ += 1
                    break
                if term or trunc:
                    break
        return succ / n_episodes


def _batch_one(obs):
    if isinstance(obs, dict):
        return {k: np.asarray(v)[None] for k, v in obs.items()}
    return np.asarray(obs)[None]


def _stack_obs(obs_list):
    """Stack observations; point clouds are cut to the smallest cloud's
    size, at most 4096 points."""
    if isinstance(obs_list[0], dict):
        n = min(min(o["points"].shape[0] for o in obs_list), 4096)
        return {k: np.stack([o[k][:n] for o in obs_list]) for k in obs_list[0]}
    return np.stack(obs_list)
