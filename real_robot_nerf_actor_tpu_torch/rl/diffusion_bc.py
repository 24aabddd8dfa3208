"""Diffusion-policy behaviour cloning (DDPM) and Diffusion Q-learning
(counterpart of the JAX package's `rl/diffusion_bc.py`).

  - make_betas: the linear or VP beta schedule in float64 numpy; the agent
    takes it to fp32 and forms alpha_bar as an fp32 cumulative product, as
    the JAX package does;
  - NoiseMLP: the noise model, a 16-frequency sinusoidal timestep embedding
    through a Dense of 32, concatenated with the noisy action and the
    observation, three relu Dense layers, a Dense to the action;
  - DiffusionBC: epsilon-prediction MSE steps (Adam) and the reverse
    sampler, n_timesteps steps from t = T-1 down to 0 (noise added at every
    step but the last), clipped to [-1, 1];
  - DiffusionQL: the critic's TD step with target actions from the EMA
    actor's full reverse sample, then the actor's step on BC + eta * Q loss
    whose gradient runs through every sampler step, soft critic targets
    (tau), and the EMA actor every `update_ema_every` updates.

Every draw can be passed in: `update`'s t and eps, the sampler's initial x
and per-step noise (T, B, A) (noise[i] at t = T-1-i), and update_ql's
`draws`; otherwise they come from the agent's `torch.Generator` (seeded
with seed + 1), drawn on the CPU. The JAX package's key splits draw other
values for the same seed. Module names are the flax trees' (NoiseMLP
`Dense_0`..`Dense_4`, TwinCritic `q{1,2}_h{0,1}`, `q{1,2}_out`). Agents run on
CUDA unless the caller passes device="cpu".
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, init_weights
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import adam


@dataclasses.dataclass(frozen=True)
class DiffusionBCConfig:
    obs_dim: int = 7
    action_dim: int = 4
    hidden_dim: int = 256
    n_timesteps: int = 100
    beta_schedule: str = "vp"   # "linear" | "vp"
    lr: float = 3e-4


def make_betas(schedule: str, t: int) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(1e-4, 2e-2, t)
    if schedule == "vp":
        ts = np.arange(1, t + 1)
        return 1.0 - np.exp(-1e-4 - 5e-3 * (2 * ts - 1) / (t ** 2) * 10)
    raise ValueError(schedule)


class NoiseMLP(nn.Module):
    def __init__(self, cfg: DiffusionBCConfig):
        super().__init__()
        h = cfg.hidden_dim
        self.Dense_0 = Dense(32, 32)
        self.Dense_1 = Dense(cfg.action_dim + 32 + cfg.obs_dim, h)
        self.Dense_2 = Dense(h, h)
        self.Dense_3 = Dense(h, h)
        self.Dense_4 = Dense(h, cfg.action_dim)

    def forward(self, action, t, obs):
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(16, dtype=torch.float32, device=action.device) / 16)
        temb = t[:, None].float() * freqs[None]
        temb = F.relu(self.Dense_0(torch.cat([torch.sin(temb), torch.cos(temb)], dim=-1)))
        x = torch.cat([action, temb, obs], dim=-1)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return self.Dense_4(x)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class DiffusionBC:
    def __init__(self, cfg: DiffusionBCConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = init_weights(NoiseMLP(cfg), torch.Generator().manual_seed(seed)).to(self.device)
        self.optimizer = adam(cfg.lr, self.net.named_parameters())
        self.generator = torch.Generator().manual_seed(seed + 1)
        betas = torch.tensor(make_betas(cfg.beta_schedule, cfg.n_timesteps), dtype=torch.float32)
        alphas = 1.0 - betas
        alpha_bar = torch.cumprod(alphas, dim=0)
        self.alpha_bar = alpha_bar.to(self.device)
        # the sampler's per-step coefficients, fp32 as the JAX step computes
        # them; kept on the CPU, where t indexes them as 0-dim scalars
        self._coef = (1 - alphas) / torch.sqrt(1 - alpha_bar)
        self._sqrt_alpha = torch.sqrt(alphas)
        self._sigma = torch.sqrt(betas)

    def _randn(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator).to(self.device)

    def noisy_actions(self, actions, t=None, eps=None):
        """(t, eps, sqrt(ab) * actions + sqrt(1 - ab) * eps)."""
        b = actions.shape[0]
        if t is None:
            t = torch.randint(0, self.cfg.n_timesteps, (b,), generator=self.generator)
        if eps is None:
            eps = torch.randn(actions.shape, generator=self.generator)
        t = torch.as_tensor(t, device=self.device).long()
        eps = _tensor(eps, self.device)
        ab = self.alpha_bar[t][:, None]
        return t, eps, torch.sqrt(ab) * actions + torch.sqrt(1.0 - ab) * eps

    def update(self, obs, actions, t=None, eps=None) -> float:
        """One Adam step on the epsilon-prediction MSE; t (B,) and eps (B, A)
        are drawn unless given."""
        obs, actions = _tensor(obs, self.device), _tensor(actions, self.device)
        t, eps, noisy = self.noisy_actions(actions, t, eps)
        self.net.zero_grad(set_to_none=True)
        loss = torch.mean((self.net(noisy, t, obs) - eps) ** 2)
        loss.backward()
        self.optimizer.step()
        return loss.item()

    def sample(self, net: nn.Module, obs: torch.Tensor, x=None, noise=None) -> torch.Tensor:
        """The reverse process of `net` from x (B, A) with per-step noise
        (T, B, A), drawn unless given; differentiable in net's weights."""
        b, a, n_t = obs.shape[0], self.cfg.action_dim, self.cfg.n_timesteps
        x = self._randn(b, a) if x is None else _tensor(x, self.device)
        noise = self._randn(n_t, b, a) if noise is None else _tensor(noise, self.device)
        for i, t in enumerate(range(n_t - 1, -1, -1)):
            eps = net(x, torch.full((b,), t, dtype=torch.long, device=self.device), obs)
            mean = (x - self._coef[t] * eps) / self._sqrt_alpha[t]
            x = mean + noise[i] * self._sigma[t] if t > 0 else mean
        return torch.clamp(x, -1.0, 1.0)

    @torch.no_grad()
    def sample_action(self, obs, x=None, noise=None) -> np.ndarray:
        """Actions for obs (B, obs_dim), or one action for obs (obs_dim,)."""
        obs = _tensor(obs, self.device)
        single = obs.dim() == 1
        a = self.sample(self.net, obs[None] if single else obs, x, noise)
        return (a[0] if single else a).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class DiffusionQLConfig:
    """DDPM actor trained with BC + eta * Q loss, twin critic with soft
    target updates, EMA actor for target actions."""
    obs_dim: int = 7
    action_dim: int = 4
    hidden_dim: int = 256
    n_timesteps: int = 100
    beta_schedule: str = "vp"
    lr: float = 3e-4
    critic_lr: float = 3e-4
    eta: float = 1.0
    discount: float = 0.99
    tau: float = 0.005
    ema_decay: float = 0.995
    update_ema_every: int = 5


class TwinCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 256):
        super().__init__()
        for q in ("q1", "q2"):
            setattr(self, f"{q}_h0", Dense(obs_dim + action_dim, hidden))
            setattr(self, f"{q}_h1", Dense(hidden, hidden))
            setattr(self, f"{q}_out", Dense(hidden, 1))

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)

        def q(name):
            h = F.relu(getattr(self, f"{name}_h0")(x))
            h = F.relu(getattr(self, f"{name}_h1")(h))
            return getattr(self, f"{name}_out")(h)[..., 0]

        return q("q1"), q("q2")


@torch.no_grad()
def _lerp_(target: nn.Module, source: nn.Module, w: float):
    """target <- w * source + (1 - w) * target, parameter by parameter."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(w * s + (1 - w) * t)


class DiffusionQL(DiffusionBC):
    def __init__(self, cfg: DiffusionQLConfig, seed: int = 0, device="cuda"):
        super().__init__(DiffusionBCConfig(
            obs_dim=cfg.obs_dim, action_dim=cfg.action_dim, hidden_dim=cfg.hidden_dim,
            n_timesteps=cfg.n_timesteps, beta_schedule=cfg.beta_schedule, lr=cfg.lr),
            seed, device)
        self.ql = cfg
        self.critic = init_weights(TwinCritic(cfg.obs_dim, cfg.action_dim, cfg.hidden_dim),
                                   torch.Generator().manual_seed(seed + 2)).to(self.device)
        self.critic_target = copy.deepcopy(self.critic)
        self.ema = copy.deepcopy(self.net)
        self.critic_optimizer = adam(cfg.critic_lr, self.critic.named_parameters())
        self.step = 0

    def update_ql(self, obs, actions, next_obs, reward, not_done,
                  draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
        """One critic step, one actor step, the soft target and (every
        update_ema_every updates, from the first) the EMA. draws, each
        drawn unless given: next_x (B, A) and next_noise (T, B, A) of the
        EMA sample, t (B,) and eps (B, A) of the BC loss, new_x and
        new_noise of the actor's sample, coin (a bool: Q1's loss if true,
        else Q2's)."""
        cfg, d = self.ql, dict(draws or {})
        obs, actions, next_obs, reward, not_done = (
            _tensor(a, self.device) for a in (obs, actions, next_obs, reward, not_done))
        with torch.no_grad():
            next_a = self.sample(self.ema, next_obs, d.get("next_x"), d.get("next_noise"))
            tq1, tq2 = self.critic_target(next_obs, next_a)
            target_q = reward + not_done * cfg.discount * torch.minimum(tq1, tq2)
        self.critic.zero_grad(set_to_none=True)
        q1, q2 = self.critic(obs, actions)
        critic_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        critic_loss.backward()
        self.critic_optimizer.step()

        t, eps, noisy = self.noisy_actions(actions, d.get("t"), d.get("eps"))
        coin = d.get("coin")
        if coin is None:
            coin = torch.rand((), generator=self.generator) < 0.5
        self.net.zero_grad(set_to_none=True)
        self.critic.requires_grad_(False)
        try:
            bc_loss = torch.mean((self.net(noisy, t, obs) - eps) ** 2)
            q1n, q2n = self.critic(obs, self.sample(self.net, obs, d.get("new_x"),
                                                    d.get("new_noise")))
            if bool(coin):
                q_loss = -q1n.mean() / (q2n.abs().mean() + 1e-8).detach()
            else:
                q_loss = -q2n.mean() / (q1n.abs().mean() + 1e-8).detach()
            actor_loss = bc_loss + cfg.eta * q_loss
            actor_loss.backward()
        finally:
            self.critic.requires_grad_(True)
        self.optimizer.step()

        _lerp_(self.critic_target, self.critic, cfg.tau)
        if self.step % cfg.update_ema_every == 0:
            _lerp_(self.ema, self.net, 1 - cfg.ema_decay)
        self.step += 1
        return {"bc_loss": bc_loss.item(), "ql_loss": q_loss.item(),
                "actor_loss": actor_loss.item(), "critic_loss": critic_loss.item()}
