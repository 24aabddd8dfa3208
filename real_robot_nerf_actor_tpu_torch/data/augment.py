"""Image augmentation for pixel RL (counterpart of the JAX package's
`data/augment.py`): random crop-shift, colour jitter and random grayscale
on (B, H, W, C) tensors.

Each function draws from `generator` (a torch.Generator; the global one
where None), or takes its draws as an argument, so that a test can feed
the JAX package's draws: the offsets (oy, ox), the factors (fb, fc, fs) and
the coin's uniforms. Means are summed in float64 and rounded to float32
once: two float64 sums in different orders lie ~1e-16 apart, which moves
the float32 mean only at a near-tie, so the card and the CPU give the same
bits whatever order they add in. The JAX package sums in float32, an ulp
or two of the mean away.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _uniform(shape, generator, device, lo=0.0, hi=1.0):
    dev = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=dev)
    return (lo + (hi - lo) * u).to(device)


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    return x.double().mean(dim=dims, keepdim=True).to(x.dtype)


def random_shift(images: torch.Tensor, pad: int = 4,
                 generator: Optional[torch.Generator] = None,
                 offsets: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Pad by `pad` with edge replication and crop back at a random offset
    per image: (B, H, W, C) -> (B, H, W, C). offsets: (oy, ox), int (B,)
    each in [0, 2 pad]; drawn from `generator` where None. The crop is one
    batched gather."""
    b, h, w, _ = images.shape
    if offsets is None:
        dev = generator.device if generator is not None else images.device
        ox = torch.randint(0, 2 * pad + 1, (b,), generator=generator, device=dev)
        oy = torch.randint(0, 2 * pad + 1, (b,), generator=generator, device=dev)
    else:
        oy, ox = offsets
    oy = torch.as_tensor(oy, device=images.device).long()
    ox = torch.as_tensor(ox, device=images.device).long()
    padded = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="replicate").permute(0, 2, 3, 1)
    rows = oy[:, None] + torch.arange(h, device=images.device)
    cols = ox[:, None] + torch.arange(w, device=images.device)
    bi = torch.arange(b, device=images.device)[:, None, None]
    return padded[bi, rows[:, :, None], cols[:, None, :]]


def color_jitter(images: torch.Tensor, brightness: float = 0.4,
                 contrast: float = 0.4, saturation: float = 0.4,
                 generator: Optional[torch.Generator] = None,
                 factors: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Per-image brightness, contrast and saturation jitter on images in
    [0, 1]. factors: (fb, fc, fs), each (B, 1, 1, 1), drawn as
    1 + U(-amount, amount) where None."""
    b = images.shape[0]
    if factors is None:
        factors = [1.0 + _uniform((b, 1, 1, 1), generator, images.device, -a, a)
                   for a in (brightness, contrast, saturation)]
    fb, fc, fs = (torch.as_tensor(f, dtype=images.dtype, device=images.device)
                  for f in factors)
    x = images * fb
    mean = _mean(x, (1, 2, 3))
    x = (x - mean) * fc + mean
    gray = _mean(x, (-1,))
    x = (x - gray) * fs + gray
    return torch.clamp(x, 0.0, 1.0)


def random_grayscale(images: torch.Tensor, p: float = 0.2,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Replace an image by its channel mean with probability p. u: the
    coin's uniforms (B, 1, 1, 1), drawn where None."""
    b = images.shape[0]
    if u is None:
        u = _uniform((b, 1, 1, 1), generator, images.device)
    coin = torch.as_tensor(u, device=images.device) < p
    gray = _mean(images, (-1,)).expand(images.shape)
    return torch.where(coin, gray, images)
