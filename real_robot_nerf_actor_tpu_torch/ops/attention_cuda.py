"""Flash attention (forward) for the PerceiverIO attention stack.

Counterpart of the JAX package's `ops/attention_pallas.py`. On a CUDA
tensor `flash_attention` launches the hand-written Hopper kernel of
`csrc/flash_attention.cu`; on a CPU tensor it runs `flash_attention_plain`,
which repeats the kernel's arithmetic in plain PyTorch. There is no other
route: a CUDA call that the kernel cannot take raises.

Layout: q (B, H, Nq, D), k/v (B, H, Nk, D), D = 64 for the kernel. Nq and
Nk may be ragged; the kernel masks keys >= Nk and rows >= Nq itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from real_robot_nerf_actor_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, sm_scale: Optional[float] = None):
    """Naive attention: fp32 scores and softmax, probabilities cast to v's
    dtype before P.V. This is the policy's einsum attention (the knob-off
    path of `MHAttention`); the JAX package's `reference_attention` differs
    only in rounding the scores to q's dtype first."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p.to(v.dtype), v)


def flash_attention_plain(q, k, v, sm_scale: Optional[float] = None):
    """The kernel's arithmetic in one pass: fp32 scores, unnormalised
    probabilities rounded to v's dtype, P.V accumulated in fp32, then
    divided by the fp32 row sum; output in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must all lie on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share a dtype of "
                        f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if d != 64 or k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError("flash_attention: the kernel takes head dim 64 and "
                         f"matching batch/heads (got {tuple(q.shape)}, {tuple(k.shape)})")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous and "
                             "16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v; q (B, H, Nq, D), k/v (B, H, Nk, D).
    Returns (B, H, Nq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale)
    _check(q, k, v)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, nq, nk, float(sm_scale), _DTYPES[q.dtype], stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
