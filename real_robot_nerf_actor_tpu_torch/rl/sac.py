"""SAC v2 on pixels or states (counterpart of the JAX package's `rl/sac.py`).

A shared encoder (for images: four 3x3 convs of 32 at flax's "SAME"
padding, strides 2, 1, 1, 1, relu, a Dense to encoder_feature_dim, then
LayerNorm and tanh; for states: none) feeding a squashed-Gaussian actor and
twin Q critics. One `update`:
  - the critic's TD step (Adam over every weight; the target from the
    current actor's squashed sample at next_obs and the target nets, with
    the entropy term), importance-weighted;
  - every actor_update_freq updates, the actor's step: the actor sees the
    encoder's features detached, and the critic scores its action with the
    weights as they are (no gradient into the encoder or the critic); then
    the temperature's step on the mean log-probability;
  - every target_update_freq updates, target <- (1 - tau) target + tau net.
The squash's Gaussian draws `eps` can be passed in (`update(batch,
eps=...)`, keys "critic" and "actor"); otherwise they come from the agent's
`torch.Generator` (seeded with seed + 1), drawn on the CPU: other values
than the JAX package's key splits for the same seed. Module names are the
flax trees' (`encoder` with `Conv_0`..`Conv_3`, `Dense_0`, `LayerNorm_0`;
`actor` with `Dense_0`..`Dense_2`; `critic` with `q{1,2}_fc{1,2}`,
`q{1,2}_out`), so convert.flax_to_state_dict maps the JAX agent's params.
The agent runs on CUDA unless the caller passes device="cpu".
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, init_weights
from real_robot_nerf_actor_tpu_torch.models.encoder2d import Conv2d
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import adam


@dataclasses.dataclass(frozen=True)
class SACConfig:
    action_dim: int = 4
    obs_type: str = "state"        # "state" | "image"
    hidden_dim: int = 256
    encoder_feature_dim: int = 50
    discount: float = 0.99
    tau: float = 0.01              # soft target update rate
    init_temperature: float = 0.1
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    alpha_lr: float = 1e-4
    actor_update_freq: int = 2
    target_update_freq: int = 2
    log_std_min: float = -10.0
    log_std_max: float = 2.0


class PixelEncoder(nn.Module):
    """(B, H, W, C) images -> (B, feature_dim) in (-1, 1)."""

    def __init__(self, obs_shape, feature_dim: int = 50):
        super().__init__()
        h, w, cin = obs_shape
        for i, s in enumerate((2, 1, 1, 1)):
            setattr(self, f"Conv_{i}", Conv2d(cin, 32, 3, s, "SAME"))
            cin, h, w = 32, -(-h // s), -(-w // s)
        self.Dense_0 = Dense(32 * h * w, feature_dim)
        self.LayerNorm_0 = nn.LayerNorm(feature_dim, eps=1e-6)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return torch.tanh(self.LayerNorm_0(self.Dense_0(x.reshape(x.shape[0], -1))))


class Actor(nn.Module):
    def __init__(self, cfg: SACConfig, feat_dim: int):
        super().__init__()
        self.cfg = cfg
        self.Dense_0 = Dense(feat_dim, cfg.hidden_dim)
        self.Dense_1 = Dense(cfg.hidden_dim, cfg.hidden_dim)
        self.Dense_2 = Dense(cfg.hidden_dim, 2 * cfg.action_dim)

    def forward(self, feat):
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(feat))))
        mu, log_std = torch.chunk(self.Dense_2(h), 2, dim=-1)
        lo, hi = self.cfg.log_std_min, self.cfg.log_std_max
        return mu, lo + 0.5 * (hi - lo) * (torch.tanh(log_std) + 1.0)


class Critic(nn.Module):
    def __init__(self, cfg: SACConfig, feat_dim: int):
        super().__init__()
        for q in ("q1", "q2"):
            setattr(self, f"{q}_fc1", Dense(feat_dim + cfg.action_dim, cfg.hidden_dim))
            setattr(self, f"{q}_fc2", Dense(cfg.hidden_dim, cfg.hidden_dim))
            setattr(self, f"{q}_out", Dense(cfg.hidden_dim, 1))

    def forward(self, feat, action):
        x = torch.cat([feat, action], dim=-1)

        def q(name):
            h = F.relu(getattr(self, f"{name}_fc1")(x))
            h = F.relu(getattr(self, f"{name}_fc2")(h))
            return getattr(self, f"{name}_out")(h)[..., 0]

        return q("q1"), q("q2")


class SACNets(nn.Module):
    """The encoder (image observations only), the actor and the critic."""

    def __init__(self, cfg: SACConfig, obs_shape):
        super().__init__()
        self.image = cfg.obs_type == "image"
        if self.image:
            self.encoder = PixelEncoder(obs_shape, cfg.encoder_feature_dim)
            feat_dim = cfg.encoder_feature_dim
        else:
            feat_dim = int(np.prod(obs_shape))
        self.actor = Actor(cfg, feat_dim)
        self.critic = Critic(cfg, feat_dim)

    def encode(self, obs):
        return self.encoder(obs) if self.image else obs

    def pi(self, obs):
        return self.actor(self.encode(obs))

    def q(self, obs, action):
        return self.critic(self.encode(obs), action)


def _squash(mu, log_std, eps):
    """tanh(mu + eps * std) and its log-probability, corrected with
    log(relu(1 - a^2) + 1e-6)."""
    a = torch.tanh(mu + eps * torch.exp(log_std))
    logp = (-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
    return a, logp - torch.log(F.relu(1.0 - a ** 2) + 1e-6).sum(-1)


@contextlib.contextmanager
def _no_grad_into(*modules):
    """The modules' weights take no gradient inside the block."""
    for m in modules:
        m.requires_grad_(False)
    try:
        yield
    finally:
        for m in modules:
            m.requires_grad_(True)


class SACAgent:
    def __init__(self, cfg: SACConfig, obs_example, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = init_weights(SACNets(cfg, np.shape(obs_example)),
                                torch.Generator().manual_seed(seed)).to(self.device)
        self.target = copy.deepcopy(self.net)
        self.log_alpha = torch.tensor(math.log(cfg.init_temperature), dtype=torch.float32,
                                      device=self.device, requires_grad=True)
        self.target_entropy = -float(cfg.action_dim)
        self.actor_opt = adam(cfg.actor_lr, self.net.named_parameters())
        self.critic_opt = adam(cfg.critic_lr, self.net.named_parameters())
        self.alpha_opt = adam(cfg.alpha_lr, [("log_alpha", self.log_alpha)])
        self._step = 0
        self.generator = torch.Generator().manual_seed(seed + 1)

    def _eps(self, shape, given=None) -> torch.Tensor:
        if given is None:
            given = torch.randn(shape, generator=self.generator)
        return torch.as_tensor(given, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- acting
    @torch.no_grad()
    def _act(self, obs, deterministic: bool, eps=None) -> np.ndarray:
        mu, log_std = self.net.pi(torch.as_tensor(obs, dtype=torch.float32,
                                                  device=self.device)[None])
        a = torch.tanh(mu) if deterministic else _squash(mu, log_std, self._eps(mu.shape, eps))[0]
        return a[0].cpu().numpy()

    def select_action(self, obs) -> np.ndarray:
        return self._act(obs, True)

    def sample_action(self, obs, eps=None) -> np.ndarray:
        return self._act(obs, False, eps)

    # ------------------------------------------------------------- updates
    def _critic_update(self, batch, eps) -> tuple:
        cfg = self.cfg
        with torch.no_grad():
            mu, log_std = self.net.pi(batch["next_obs"])
            next_a, next_logp = _squash(mu, log_std, eps)
            tq1, tq2 = self.target.q(batch["next_obs"], next_a)
            target_v = torch.minimum(tq1, tq2) - torch.exp(self.log_alpha) * next_logp
            target_q = batch["reward"] + (1.0 - batch["done"]) * cfg.discount * target_v
        self.net.zero_grad(set_to_none=True)
        q1, q2 = self.net.q(batch["obs"], batch["action"])
        td1, td2 = q1 - target_q, q2 - target_q
        loss = (batch["weights"] * (td1 ** 2 + td2 ** 2)).mean()
        loss.backward()
        self.critic_opt.step()
        return loss, (td1.abs() + td2.abs()).detach()

    def actor_loss(self, obs, eps) -> tuple:
        """(loss, log-probabilities) of the actor on obs: the features
        detached, the critic's weights taking no gradient."""
        mu, log_std = self.net.actor(self.net.encode(obs).detach())
        a, logp = _squash(mu, log_std, eps)
        with _no_grad_into(self.net.critic, *([self.net.encoder] if self.net.image else [])):
            q1, q2 = self.net.q(obs, a)
        return (torch.exp(self.log_alpha.detach()) * logp - torch.minimum(q1, q2)).mean(), logp

    def _actor_update(self, batch, eps) -> tuple:
        self.net.zero_grad(set_to_none=True)
        loss, logp = self.actor_loss(batch["obs"], eps)
        loss.backward()
        self.actor_opt.step()
        return loss, logp.mean().detach()

    def _alpha_update(self, mean_logp) -> torch.Tensor:
        self.log_alpha.grad = None
        loss = -(torch.exp(self.log_alpha) * (mean_logp + self.target_entropy))
        loss.backward()
        self.alpha_opt.step()
        return loss

    def update(self, batch: Dict[str, np.ndarray],
               eps: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """One update on a replay batch (obs, action, reward, next_obs, done,
        weights; idx ignored). eps: the squash draws {"critic": (B, A),
        "actor": (B, A)}, each drawn unless given. Returns the losses, alpha
        and td_abs (|td1| + |td2|, numpy), for the buffer's priorities."""
        eps = dict(eps or {})
        batch = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                 for k, v in batch.items() if k != "idx"}
        shape = batch["action"].shape
        e_critic = self._eps(shape, eps.get("critic"))
        e_actor = self._eps(shape, eps.get("actor"))
        critic_loss, td = self._critic_update(batch, e_critic)
        metrics = {"critic_loss": critic_loss.item()}
        if self._step % self.cfg.actor_update_freq == 0:
            actor_loss, mean_logp = self._actor_update(batch, e_actor)
            self._alpha_update(mean_logp)
            metrics.update(actor_loss=actor_loss.item(), alpha=self.log_alpha.exp().item())
        if self._step % self.cfg.target_update_freq == 0:
            with torch.no_grad():
                tau = self.cfg.tau
                for t, p in zip(self.target.parameters(), self.net.parameters()):
                    t.copy_((1 - tau) * t + tau * p)
        self._step += 1
        metrics["td_abs"] = td.cpu().numpy()
        return metrics
