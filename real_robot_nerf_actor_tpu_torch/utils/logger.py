"""Console + JSON-lines metrics logger with optional TensorBoard and W&B
sinks (the port's copy of the JAX package's `utils/logger.py`).

`metrics.jsonl` under `log_dir` is the always-on machine-readable record;
TensorBoard and W&B are attached only when they are asked for and their
packages import, and both receive the same scalars and image panels.
"""
from __future__ import annotations

import json
import os
import struct
import sys
import time
import zlib
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class AverageMeter:
    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def update(self, value: float, n: int = 1):
        self._sum += value * n
        self._count += n

    def value(self) -> float:
        return self._sum / max(1, self._count)

    def reset(self):
        self._sum, self._count = 0.0, 0


class Logger:
    def __init__(self, log_dir: Optional[str] = None, use_tensorboard: bool = False,
                 print_every: int = 50, use_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_config: Optional[dict] = None):
        self.log_dir = log_dir
        self.print_every = print_every
        self._meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self._jsonl = None
        self._tb = None
        self._wandb = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except ImportError:
                    self._tb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(
                    project=wandb_project or "real-robot-nerf-actor-tpu",
                    dir=log_dir or ".", config=wandb_config or {})

    def log(self, metrics: Dict[str, float], step: int, category: str = "train"):
        rec = {"step": step, "category": category, "time": time.time() - self._t0}
        for k, v in metrics.items():
            v = float(v)
            rec[k] = v
            self._meters[f"{category}/{k}"].update(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{category}/{k}", v, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({f"{category}/{k}": float(v)
                             for k, v in metrics.items()}, step=step)
        if step % self.print_every == 0:
            msg = " | ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            print(f"[{category}] step {step} | {msg} | "
                  f"t={time.time() - self._t0:.1f}s", file=sys.stderr)

    def log_image_panel(self, name: str, images, step: int,
                        category: str = "train"):
        """Images side by side, padded to a common height: a list of
        (H, W, 3) or (H, W) float arrays in [0, 1] (a grey image is
        stretched to its range). Written as PNG under <log_dir>/panels and
        to the sinks; returns the PNG's path, or None without a log_dir."""
        panels = []
        hmax = max(int(np.shape(im)[0]) for im in images)
        for im in images:
            a = np.asarray(im, np.float32)
            if a.ndim == 2:
                lo, hi = float(a.min()), float(a.max())
                a = (a - lo) / (hi - lo + 1e-8)
                a = np.stack([a] * 3, -1)
            if a.shape[0] < hmax:
                a = np.concatenate(
                    [a, np.zeros((hmax - a.shape[0], *a.shape[1:]), a.dtype)], 0)
            panels.append(np.clip(a, 0.0, 1.0))
        panel = np.concatenate(panels, axis=1)
        if self._tb is not None:
            self._tb.add_image(f"{category}/{name}", panel, step, dataformats="HWC")
        if self._wandb is not None:
            import wandb
            self._wandb.log({f"{category}/{name}": wandb.Image(panel)}, step=step)
        if self.log_dir:
            d = os.path.join(self.log_dir, "panels")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{name}_{step:08d}.png")
            _write_png(path, (panel * 255).astype("uint8"))
            return path
        return None

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def _write_png(path: str, rgb) -> None:
    """A minimal 8-bit RGB PNG writer."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
