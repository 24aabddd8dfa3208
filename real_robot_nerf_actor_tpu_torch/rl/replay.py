"""Experience replay: uniform and prioritized (counterpart of the JAX
package's `rl/replay.py`, the same numpy code).

Host-side numpy ring buffers; proportional prioritization with alpha / beta
annealing and importance weights, sampled by `Generator.choice` over the
normalised priorities (O(n) per batch). Both draw from numpy's
default_rng(seed) in the JAX package's order, so a seed samples the same
indices there and here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_shape, action_dim: int,
                 obs_dtype=np.float32, seed: int = 0):
        self.capacity = capacity
        self.obs = np.empty((capacity, *obs_shape), obs_dtype)
        self.next_obs = np.empty((capacity, *obs_shape), obs_dtype)
        self.actions = np.empty((capacity, action_dim), np.float32)
        self.rewards = np.empty((capacity,), np.float32)
        self.dones = np.empty((capacity,), np.float32)
        self.idx = 0
        self.full = False
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self.capacity if self.full else self.idx

    def add(self, obs, action, reward, next_obs, done):
        i = self.idx
        self.obs[i] = obs
        self.actions[i] = action
        self.rewards[i] = reward
        self.next_obs[i] = next_obs
        self.dones[i] = float(done)
        self.idx = (i + 1) % self.capacity
        self.full = self.full or self.idx == 0

    def _gather(self, idx) -> Dict[str, np.ndarray]:
        return {"obs": self.obs[idx], "action": self.actions[idx],
                "reward": self.rewards[idx], "next_obs": self.next_obs[idx],
                "done": self.dones[idx]}

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self), batch_size)
        batch = self._gather(idx)
        batch["weights"] = np.ones(batch_size, np.float32)
        batch["idx"] = idx
        return batch

    def update_priorities(self, idx, priorities):  # no-op for uniform
        pass


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int, obs_shape, action_dim: int,
                 alpha: float = 0.6, beta: float = 0.4,
                 beta_steps: int = 100000, obs_dtype=np.float32, seed: int = 0):
        super().__init__(capacity, obs_shape, action_dim, obs_dtype, seed)
        self.alpha = alpha
        self.beta0 = beta
        self.beta_steps = beta_steps
        self._samples = 0
        self.priorities = np.zeros((capacity,), np.float64)
        self._max_priority = 1.0

    def add(self, obs, action, reward, next_obs, done):
        self.priorities[self.idx] = self._max_priority
        super().add(obs, action, reward, next_obs, done)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        n = len(self)
        p = self.priorities[:n] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(n, batch_size, p=p)
        self._samples += 1
        beta = min(1.0, self.beta0 + (1.0 - self.beta0)
                   * self._samples / max(1, self.beta_steps))
        weights = (n * p[idx]) ** (-beta)
        weights = weights / weights.max()
        batch = self._gather(idx)
        batch["weights"] = weights.astype(np.float32)
        batch["idx"] = idx
        return batch

    def update_priorities(self, idx, priorities):
        priorities = np.abs(np.asarray(priorities)) + 1e-6
        self.priorities[idx] = priorities
        self._max_priority = max(self._max_priority, float(priorities.max()))
