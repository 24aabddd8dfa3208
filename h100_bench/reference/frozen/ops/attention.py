"""The policy's plain attention (the port's `ops/attention_cuda.py`
`reference_attention`, frozen alone)."""
from __future__ import annotations

from typing import Optional

import torch


def reference_attention(q, k, v, sm_scale: Optional[float] = None):
    """Naive attention: fp32 scores and softmax (float64 for float64
    inputs), probabilities cast to v's dtype before P.V. This is the
    policy's einsum attention (the knob-off path of `MHAttention`); the JAX
    package's `reference_attention` differs only in rounding the scores to
    q's dtype first."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    wide = torch.promote_types(q.dtype, torch.float32)   # float64 stays float64
    s = torch.einsum("bhid,bhjd->bhij", q.to(wide), k.to(wide)) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p.to(v.dtype), v)
