"""Dynamic W8A8 int8 matmul for serving the NeRF field's MLP (counterpart of
the JAX package's `ops/quant.py`).

Symmetric quantization, per row for activations and per output column for
weights, int32 accumulation, then the fp32 rescale `acc * (xs * ws)`. The
weights quantize from the same fp32 parameters on every call, so a
checkpoint trained in fp32 serves quantized through a config flag
(`NerfFieldConfig.quantized`). `round` is round-half-even, as in JAX.

The JAX package computes the product with an XLA dot, not a Pallas kernel.
Here it is `torch._int_mm` on CUDA (rows padded to its shape limits with
zero rows, which add nothing to the exact int32 sums) and an int32 matmul
on the CPU. Serving only: `int8_matmul` raises in its backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SERVING_ONLY = ("int8_matmul (QuantDense / NerfFieldConfig.quantized) is a "
                "serving-only path: round() has zero gradient, so training through "
                "it would silently learn nothing. Train with quantized=False and "
                "serve the same checkpoint quantized.")


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 rounded once to amax's dtype. The divisor is a tensor:
    CUDA divides by a host scalar as a product with its reciprocal, which
    rounds some quotients one ulp away from the CPU's (and JAX's)."""
    return amax / torch.full_like(amax, 127.0)


def quantize_rows(x: torch.Tensor, eps: float = 1e-8):
    """Per-row symmetric int8: x (N, K) -> (int8 (N, K), scale (N, 1) fp32).
    The scale is computed in x's dtype and then widened, as JAX does."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (_div127(amax) + eps).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_cols(w: torch.Tensor, eps: float = 1e-8):
    """Per-output-channel symmetric int8: w (K, M) -> (int8, scale (1, M))."""
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = (_div127(amax) + eps).float()
    q = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (N, K) and (K, M). On CUDA through
    `torch._int_mm`, which takes more than 16 rows and K, M multiples of 8:
    the operands are padded with zeros to meet that and the result cut back."""
    if not xq.is_cuda:
        return xq.to(torch.int32) @ wq.to(torch.int32)
    n, k = xq.shape
    m = wq.shape[1]
    np_, kp, mp = max(_round_up(n, 8), 24), _round_up(k, 8), _round_up(m, 8)
    if (np_, kp) != (n, k):
        xq = F.pad(xq, (0, kp - k, 0, np_ - n))
    if (kp, mp) != (k, m):
        wq = F.pad(wq, (0, mp - m, 0, kp - k))
    return torch._int_mm(xq.contiguous(), wq.contiguous())[:n, :m]


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype):
        xq, xs = quantize_rows(x)
        wq, ws = quantize_cols(w)
        acc = int_matmul(xq, wq)
        return (acc.float() * (xs * ws)).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(SERVING_ONLY)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y = x @ w with dynamic W8A8 quantization and int32 accumulation.
    x (N, K) float, w (K, M) float; returns (N, M) in out_dtype. A backward
    through it raises."""
    return _Int8Matmul.apply(x, w, out_dtype)
