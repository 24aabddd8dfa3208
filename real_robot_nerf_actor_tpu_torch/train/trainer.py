"""Trainer runtime of the port: optimizer, checkpoint and resume, logging,
the step loop (counterpart of the JAX package's `train/trainer.py`).

`Optimizer` is the JAX package's `make_optimizer` chain,
apply_if_finite(MultiSteps(clip_by_global_norm -> adamw)), with optax's
arithmetic around one `torch.optim.AdamW`. Differences from the JAX
package, all deliberate:
  - checkpoints are `torch.save` files (module state_dict, optimizer state,
    step), not Orbax directories; the retention is the same (latest +
    backup, and the best in `<ckpt_dir>_best`);
  - the per-step randomness (and the weights' draw) comes from one
    `torch.Generator` seeded with `cfg.seed`, not from `jax.random.split`:
    the same seed gives other draws;
  - the step runs eagerly (no jit, no buffer donation): `train_step`
    updates the module and the optimizer in place;
  - the non-finite check reads one flag on the host each step;
  - a non-finite gradient let through by apply_if_finite's over-limit
    branch on a MultiSteps mini-step that does not emit leaves the
    parameters as they are; optax's zero update is then 0 * NaN.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.utils.logger import Logger
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-6
    grad_clip: float = 0.0
    name: str = "adamw"
    lr_decay_rate: float = 0.0   # exponential decay per step (0 = constant)
    accum_steps: int = 1         # gradient accumulation
    schedule: str = "constant"   # 'constant' | 'cosine' (needs decay_steps)
    warmup_steps: int = 0
    decay_steps: int = 0         # cosine horizon (usually num_steps)
    min_lr_frac: float = 0.05    # final LR = min_lr_frac * lr
    skip_nonfinite: int = 100    # consecutive non-finite updates dropped; 0 off


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 100000
    log_every: int = 50
    ckpt_every: int = 10000
    eval_every: int = 2000
    seed: int = 0
    ckpt_dir: Optional[str] = None
    log_dir: Optional[str] = None
    max_ckpts_to_keep: int = 2   # latest + backup
    prefetch: int = 2            # host batches in flight; 0 disables
    best_key: Optional[str] = None   # eval metric that selects the best ckpt
    best_mode: str = "max"       # 'max' | 'min'
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a daemon thread, keeping `depth` items ready. An
    exception of the iterator is raised in the consumer, not taken for the
    iterator's end."""
    if depth <= 0:
        return it
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised in gen()
            err.append(e)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()

    def gen():
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            yield item

    return gen()


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate of `make_optimizer` at optax's 0-based count of
    inner updates, in fp32 as optax evaluates it.

    cosine: optax.warmup_cosine_decay_schedule from 0 over warmup_steps
    (so the first update is zero), or from lr over one step without a
    warmup; decay_steps includes the warmup. lr_decay_rate > 0:
    lr * (1 - rate)^count. Otherwise lr."""
    f32 = np.float32
    if cfg.schedule == "cosine":
        if cfg.decay_steps <= 0:
            raise ValueError("schedule='cosine' needs decay_steps")
        init = 0.0 if cfg.warmup_steps > 0 else cfg.lr
        peak, end = cfg.lr, cfg.min_lr_frac * cfg.lr
        warm = max(cfg.warmup_steps, 1)
        span = float(cfg.decay_steps - warm)
        alpha = 0.0 if peak == 0.0 else end / peak

        def schedule(count: int) -> float:
            if count < warm:    # optax.linear_schedule(init, peak, warm)
                frac = f32(1) - f32(count) / f32(warm)
                return float(f32(init - peak) * frac + f32(peak))
            c = f32(min(float(count - warm), span))
            cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span)))
            return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))
        return schedule
    if cfg.lr_decay_rate > 0:
        rate = f32(1.0 - cfg.lr_decay_rate)

        def schedule(count: int) -> float:
            if count <= 0:
                return cfg.lr
            return float(f32(cfg.lr) * np.power(rate, f32(count)))
        return schedule
    return lambda count: cfg.lr


# optax's b1 and b2 as it computes with them: in fp32, where 0.9 and 0.999
# are not exact (its bias correction 1 - b2^t uses fp32(0.999), 1.3e-5
# relative away from 0.999 at t = 1)
_BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))


def _all_finite(tensors) -> bool:
    """Whether every element of every tensor is finite, read on the host
    once: x * 0 is 0 for a finite x and NaN otherwise, and a sum keeps a
    NaN (a norm of the values themselves could overflow where they are
    all finite)."""
    zeros = torch._foreach_mul(tensors, 0.0)
    return bool(torch.isfinite(torch.stack(torch._foreach_norm(zeros, 1)).sum()))


class Optimizer:
    """`make_optimizer`'s chain over `named_params`, stepping on each
    parameter's `.grad` (None counts as zeros):

      apply_if_finite(skip_nonfinite): a gradient with a NaN or an Inf
        gives no update and touches neither the accumulator nor the Adam
        moments, unless more than skip_nonfinite came in a row;
      MultiSteps(accum_steps): the running mean of accum_steps gradients,
        acc + (g - acc) / (n + 1), reaches the inner update on the last
        of them; the others give no update;
      clip_by_global_norm(grad_clip): g * (grad_clip / |g|) when
        |g| >= grad_clip, with no epsilon;
      adamw (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay scaled by
        the scheduled lr) or adam (no decay), on one torch.optim.AdamW,
        at the lr of `make_schedule` for the count of inner updates.

    The parameters' `.grad` are left as the caller's backward made them.

    `sync` (set by parallel.train_dp for a data- or tensor-parallel step)
    first replaces every `.grad` by its mean over the data ranks, reduces
    the non-finite flag over every rank, so that no rank skips a step
    another takes, and takes the clip's global norm over the model ranks'
    shards; None steps on this process's gradients alone.
    """

    sync = None

    def __init__(self, cfg: OptimConfig, named_params: Iterable[Tuple[str, torch.Tensor]]):
        if cfg.name not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.names, self.params = map(list, zip(*named_params))
        self.schedule = make_schedule(cfg)
        self.weight_decay = cfg.weight_decay if cfg.name == "adamw" else 0.0
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=_BETAS,
                                       eps=1e-8, weight_decay=self.weight_decay)
        self.count = 0            # inner updates: optax's ScaleByAdamState.count
        self.notfinite_count = 0  # ApplyIfFiniteState
        self.total_notfinite = 0 if cfg.skip_nonfinite > 0 else None
        self.last_finite = True
        self.mini_step = 0        # MultiStepsState
        self.gradient_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params] if cfg.accum_steps > 1
                    else None)

    def structure(self) -> Dict[str, Any]:
        """What decides the shape of the optax state: a checkpoint of
        another structure restores params-only (see Trainer.run)."""
        c = self.cfg
        return {"name": c.name, "scheduled": c.schedule == "cosine" or c.lr_decay_rate > 0,
                "clip": c.grad_clip > 0, "accum": c.accum_steps > 1,
                "skip_nonfinite": c.skip_nonfinite > 0}

    def step(self) -> bool:
        """One update from the gradients in `.grad`; whether the inner
        (AdamW) update ran."""
        c = self.cfg
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.sync is not None:
            grads = self.sync.reduce_grads(self.params, grads)
        if c.skip_nonfinite > 0:
            with named_scope("optimizer.finite_check"):   # the host waits for the flag
                finite = _all_finite(grads)
                if self.sync is not None:
                    finite = self.sync.all_finite(finite)
            self.last_finite = finite
            if not finite:
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count <= c.skip_nonfinite:
                    return False
            else:
                self.notfinite_count = 0
        if self.acc is not None:
            n = self.mini_step
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (n + 1) % c.accum_steps
            if n != c.accum_steps - 1:
                return False
            grads = self.acc
            self.gradient_step += 1
        if c.grad_clip > 0:
            norms = torch.stack(torch._foreach_norm(grads, 2))
            g_norm = (torch.linalg.vector_norm(norms) if self.sync is None
                      else self.sync.global_norm(norms))
            scale = torch.where(g_norm < c.grad_clip, torch.ones_like(g_norm),
                                c.grad_clip / g_norm)
            grads = torch._foreach_mul(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        raw = [p.grad for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        for p, g in zip(self.params, raw):
            p.grad = g
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    _COUNTERS = ("count", "notfinite_count", "total_notfinite", "last_finite",
                 "mini_step", "gradient_step")

    def state_dict(self) -> Dict[str, Any]:
        sd = {k: getattr(self, k) for k in self._COUNTERS}
        sd.update(structure=self.structure(), acc=self.acc, adamw=self.adamw.state_dict())
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Raises ValueError, changing nothing, when the state is of another
        structure (see `structure`)."""
        if sd["structure"] != self.structure():
            raise ValueError(f"optimizer state of structure {sd['structure']}, "
                             f"this optimizer is {self.structure()}")
        for k in self._COUNTERS:
            setattr(self, k, sd[k])
        if self.acc is not None:
            self.acc = [a.to(p.device, p.dtype) for a, p in zip(sd["acc"], self.params)]
        self.adamw.load_state_dict(sd["adamw"])
        for group in self.adamw.param_groups:   # the config's decay, as optax's closure
            group["weight_decay"] = self.weight_decay

    def load_moments(self, count: int, mu: Dict[str, torch.Tensor],
                     nu: Dict[str, torch.Tensor]) -> None:
        """Set the Adam state by parameter name: `count` inner updates made,
        first moments `mu`, second moments `nu` (in the parameters' layout)."""
        self.count = count
        for name, p in zip(self.names, self.params):
            self.adamw.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu[name].to(p.device, p.dtype).clone(),
                "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}


def adam(lr: float, named_params: Iterable[Tuple[str, torch.Tensor]]) -> Optimizer:
    """optax.adam(lr) as an Optimizer: no weight decay, no clipping, no
    non-finite check."""
    return Optimizer(OptimConfig(lr=lr, name="adam", weight_decay=0.0, skip_nonfinite=0),
                     named_params)


@dataclasses.dataclass
class TrainState:
    step: int
    module: torch.nn.Module
    optimizer: Optimizer
    extra: Any = None    # e.g. batch statistics of BatchNorm models


class CheckpointManager:
    """`torch.save` checkpoints, one file per step (`ckpt_<step>.pt`:
    step, module state_dict, optimizer state, extra); only the newest
    `max_to_keep` stay (latest + backup)."""

    _NAME = re.compile(r"ckpt_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 2):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step}.pt")

    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(self._NAME.match, os.listdir(self._dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, params=None, opt_state=None):
        """Write `state` as ckpt_<step>.pt; params / opt_state, where given,
        stand in for its module's state_dict and its optimizer's (a
        tensor-parallel run passes the whole ones)."""
        payload = {"step": int(state.step),
                   "params": state.module.state_dict() if params is None else params,
                   "opt_state": (state.optimizer.state_dict() if opt_state is None
                                 else opt_state),
                   "extra": state.extra}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _load(self, step: Optional[int]):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore_raw_params(self, step: Optional[int] = None):
        """The checkpoint's module state_dict as it was saved, with no
        module to load it into (for warm starts across configs)."""
        raw = self._load(step)
        return None if raw is None else raw["params"]

    def restore(self, state_like: TrainState, step: Optional[int] = None,
                params_only: bool = False) -> Optional[TrainState]:
        """Load the checkpoint into `state_like`'s module (and optimizer)
        and return it, or None without a checkpoint. params_only=True keeps
        `state_like`'s optimizer: evaluation and serving of a checkpoint do
        not depend on the optimizer it was trained with. A full restore of a
        checkpoint whose optimizer has another structure raises ValueError
        before anything is loaded."""
        raw = self._load(step)
        if raw is None:
            return None
        if not params_only and raw["opt_state"]["structure"] != state_like.optimizer.structure():
            raise ValueError(f"the checkpoint's optimizer is "
                             f"{raw['opt_state']['structure']}, this run's is "
                             f"{state_like.optimizer.structure()}")
        state_like.module.load_state_dict(raw["params"])
        if not params_only:
            state_like.optimizer.load_state_dict(raw["opt_state"])
        state_like.step = int(raw["step"])
        state_like.extra = raw.get("extra", state_like.extra)
        return state_like


class Trainer:
    """Generic step-driven trainer over
      - init_state(generator) -> TrainState
      - train_step(state, batch, generator) -> (state, metrics)
      - data: an iterator of batches
      - optional eval_fn(state, step) -> metrics dict.
    One torch.Generator seeded with cfg.seed draws the weights and then
    every step's randomness."""

    def __init__(self, cfg: TrainConfig, train_step: Callable, data: Iterator,
                 init_state: Callable[[torch.Generator], TrainState],
                 eval_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.data = prefetch_iterator(data, cfg.prefetch)
        self.eval_fn = eval_fn
        self._init_state = init_state
        self._step_fn = train_step
        self.logger = Logger(cfg.log_dir, print_every=cfg.log_every)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, cfg.max_ckpts_to_keep)
                     if cfg.ckpt_dir else None)
        self.best_ckpt = (CheckpointManager(cfg.ckpt_dir + "_best", max_to_keep=1)
                          if cfg.ckpt_dir and cfg.best_key else None)

    def _best_path(self) -> str:
        return os.path.join(self.cfg.ckpt_dir + "_best", "best.json")

    def _load_best(self) -> Optional[float]:
        try:
            with open(self._best_path()) as f:
                return float(json.load(f)["value"])
        except (OSError, ValueError, KeyError):
            return None

    def _maybe_save_best(self, state: TrainState, step: int, metrics: Dict[str, Any]):
        if self.best_ckpt is None or self.cfg.best_key not in metrics:
            return
        val = float(metrics[self.cfg.best_key])
        prev = self._load_best()
        better = (prev is None
                  or (val > prev if self.cfg.best_mode == "max" else val < prev))
        if better:
            self.best_ckpt.save(step, state)
            with open(self._best_path(), "w") as f:
                json.dump({"key": self.cfg.best_key, "value": val, "step": step}, f)
            print(f"[trainer] new best {self.cfg.best_key}={val:.4f} at step {step}")

    def run(self, resume: bool = True) -> TrainState:
        generator = torch.Generator().manual_seed(self.cfg.seed)
        state = self._init_state(generator)
        start = 0
        if resume and self.ckpt is not None:
            try:
                restored = self.ckpt.restore(state)
            except ValueError as e:
                # the optimizer changed since the checkpoint was written
                # (e.g. a fine-tune adds accumulation): carry the params and
                # the step over and start the optimizer fresh
                print(f"[trainer] full-state resume failed ({e}); retrying params-only")
                restored = self.ckpt.restore(state, params_only=True)
            if restored is not None:
                state = restored
                start = int(state.step)
                print(f"[trainer] resumed from step {start}")

        t_last = time.time()
        for step in range(start, self.cfg.num_steps):
            batch = next(self.data)
            state, metrics = self._step_fn(state, batch, generator)
            if (step + 1) % self.cfg.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                if state.optimizer.total_notfinite is not None:
                    metrics["grad_skips"] = float(state.optimizer.total_notfinite)
                metrics["steps_per_sec"] = self.cfg.log_every / (time.time() - t_last)
                t_last = time.time()
                self.logger.log(metrics, step + 1)
            if self.eval_fn is not None and (step + 1) % self.cfg.eval_every == 0:
                ev = self.eval_fn(state, step + 1)
                if ev:
                    self.logger.log(ev, step + 1, category="eval")
                    self._maybe_save_best(state, step + 1, ev)
            if self.ckpt is not None and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        if self.ckpt is not None and int(state.step) % self.cfg.ckpt_every != 0:
            self.ckpt.save(int(state.step), state)
        return state
