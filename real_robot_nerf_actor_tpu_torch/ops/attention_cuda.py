"""Flash attention (forward) for the PerceiverIO attention stack.

Counterpart of the JAX package's `ops/attention_pallas.py`. On a CUDA
tensor `flash_attention` launches the hand-written Hopper kernels of
`csrc/flash_attention.cu`: bf16 (every call of the policy) goes to the
wgmma/TMA kernel, with the key range split over several blocks where the
query tiles alone cannot fill the card (`plan_splits`), and fp32 to the
SIMT kernel. On a CPU tensor it runs `flash_attention_plain`, which repeats
the kernel's arithmetic in plain PyTorch. There is no other route: a CUDA
call that neither kernel takes raises.

Layout: q (B, H, Nq, D), k/v (B, H, Nk, D), D = 64 for the kernels, each
with any strides whose last one is 1 (so `MHAttention` hands in its
split-heads views without a copy); `out`, if given, is written in place in
the caller's layout. Nq and Nk may be ragged; the kernels mask keys >= Nk
and rows >= Nq themselves.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from real_robot_nerf_actor_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ, BKV = 128, 64          # query rows per block, keys per tile (bf16 kernel)
SMS = 132                  # streaming multiprocessors of an H100 SXM
_SMS_BY_DEVICE = {}


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


def plan_splits(bh: int, nq: int, nk: int, sms: int = SMS) -> int:
    """Key splits of one bf16 call: enough blocks of 128 query rows to fill
    the card's SMs once (never more than one wave), each split at least four
    64-key tiles. 1 x 2048 x 8077 -> 8 (128 blocks), 1 x 8077 x 2048 -> 2
    (128), 8 x 2048 x 2048 -> 1 (128 blocks already)."""
    blocks = bh * math.ceil(nq / BQ)
    tiles = math.ceil(nk / BKV)
    want = max(1, min(sms // blocks, tiles // 4))
    # splits of whole tiles, none empty
    return math.ceil(tiles / math.ceil(tiles / want))


def flash_attention_split_plain(q, k, v, splits: int,
                                sm_scale: Optional[float] = None):
    """The split-key algebra of the bf16 kernel in plain PyTorch: the key
    range cut into `splits` chunks of whole 64-key tiles, each chunk's
    (m, l, acc) in fp32 (probabilities rounded to v's dtype before P.V, as
    in one pass), then the combine: m = max m_s, l = sum l_s e^(m_s - m),
    o = sum acc_s e^(m_s - m) / l (1 where l == 0), in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    nk = k.shape[2]
    tiles = math.ceil(nk / BKV)
    per = math.ceil(tiles / splits) * BKV
    ms, ls, accs = [], [], []
    for k0 in range(0, nk, per):
        kc, vc = k[:, :, k0:k0 + per], v[:, :, k0:k0 + per]
        s = torch.einsum("bhid,bhjd->bhij", q.float(), kc.float()) * sm_scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), vc.float()))
    m = torch.stack(ms).amax(dim=0)
    w = [torch.exp(ms_ - m) for ms_ in ms]
    l = sum(l_ * w_ for l_, w_ in zip(ls, w))
    acc = sum(a_ * w_ for a_, w_ in zip(accs, w))
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


def _check(q, k, v, out):
    if not (q.is_cuda and k.is_cuda and v.is_cuda
            and (out is None or out.is_cuda)):
        raise ValueError("flash_attention: q, k, v (and out) must all lie on one "
                         f"CUDA device (got {q.device}, {k.device}, {v.device})")
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError("flash_attention: q, k, v must share a dtype of "
                        f"float32 or bfloat16 (got {dt}, {k.dtype}, {v.dtype})")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"flash_attention: bad shapes {tuple(qs)}, "
                         f"{tuple(ks)}, {tuple(v.shape)}")
    if qs[3] != 64 or ks[0] != qs[0] or ks[1] != qs[1] or ks[3] != 64:
        raise ValueError("flash_attention: the kernel takes head dim 64 and "
                         f"matching batch/heads (got {tuple(qs)}, {tuple(ks)})")
    if ks[2] == 0:
        raise ValueError("flash_attention: no keys")
    if out is not None and (out.shape != qs or out.dtype != dt):
        raise ValueError(f"flash_attention: out must be {tuple(qs)} {dt}, "
                         f"got {tuple(out.shape)} {out.dtype}")


def _layout(tensors, per16):
    """The kernels' (b, h, n) element strides of q, k, v, out, 12 values; a
    dim of size 1 gets the stride of the next-outer extent, so that every
    stride is a multiple of 16 bytes whatever torch reports for it. Raises
    unless each tensor has a last stride of 1, a 16-byte aligned start and
    other strides of whole 16 bytes."""
    strides = []
    for t in tensors:
        (b, h, n, _), (sb, sh, sn, sd) = t.shape, t.stride()
        if n == 1:
            sn = 64
        if h == 1:
            sh = sn * n
        if b == 1:
            sb = sh * h
        if sd != 1 or t.data_ptr() % 16 or sb % per16 or sh % per16 or sn % per16:
            raise ValueError("flash_attention: every tensor needs a last stride of 1, "
                             "a 16-byte aligned start and other strides of whole "
                             f"16 bytes (got strides {t.stride()})")
        strides += (sb, sh, sn)
    return (ctypes.c_longlong * 12)(*strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v; q (B, H, Nq, D), k/v (B, H, Nk, D).
    Returns (B, H, Nq, D) in q's dtype, written into `out` when given."""
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, sm_scale)
        return res if out is None else out.copy_(res)
    _check(q, k, v, out)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("flash_attention")
    bf16 = q.dtype == torch.bfloat16
    tiles = math.ceil(nk / BKV)
    if bf16:
        sms = _SMS_BY_DEVICE.get(q.device.index)
        if sms is None:
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            _SMS_BY_DEVICE[q.device.index] = sms
        per = math.ceil(tiles / plan_splits(b * h, nq, nk, sms))
        n_splits = math.ceil(tiles / per)
    else:
        per, n_splits = tiles, 1
    strides = _layout((q, k, v, out), 16 // q.element_size())
    part_o = part_ml = None
    if n_splits > 1:
        # fp32 scratch of the splits: acc (64 values a row), then (m, l)
        rows = n_splits * b * h * nq
        scratch = torch.empty(rows * 66, dtype=torch.float32, device=q.device)
        part_o = scratch.data_ptr()
        part_ml = part_o + rows * 64 * 4
    device = q.device.index

    def launch():
        return lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_o, part_ml,
            b, h, nq, nk, n_splits, per, strides, float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(device).cuda_stream)

    if device == torch.cuda.current_device():
        code = launch()
    else:                       # the launch goes to the current device
        with torch.cuda.device(device):
            code = launch()
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    if bf16:
        flash_attention.wgmma_launches += 1
        flash_attention.last_plan = {"splits": n_splits,
                                     "blocks": math.ceil(nq / BQ) * b * h * n_splits}
    return out


flash_attention.launches = 0        # calls that launched a kernel (either design)
flash_attention.wgmma_launches = 0  # of those, calls of the bf16 wgmma/TMA kernel
flash_attention.last_plan = None    # splits and blocks of the last bf16 call
