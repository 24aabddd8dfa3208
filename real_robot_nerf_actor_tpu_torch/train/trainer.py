"""Training configuration (the port's copy of the config dataclasses of
the JAX package's `train/trainer.py`). The trainer itself comes with the
training slice; the fields are kept as data so `configs/peract.yaml` loads
into both packages, with the JAX package's meanings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
