"""The control of each correctness check: the reference computed one
precision below the configuration's, so that the check is seen to fail it.
Inside `LowerPrecision(kind)` every matrix product and convolution takes
its two operands rounded, tensor by tensor with a scale from the tensor's
largest magnitude, to fp8 (e4m3, the step below bf16) or int4 (the step
below int8); gradients pass the rounding straight through."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PRODUCTS = {F.linear, F.conv3d, F.conv_transpose3d, torch.matmul, torch.mm, torch.bmm,
             torch.Tensor.__matmul__, torch.einsum}


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    xf = x.float()
    if kind == "fp8":
        s = amax / 448.0
        q = (xf / s).to(torch.float8_e4m3fn).float() * s
    elif kind == "int4":
        s = amax / 7.0
        q = torch.round(xf / s).clamp(-7, 7) * s
    else:
        raise ValueError(f"unknown precision {kind!r}")
    return x + (q.to(x.dtype) - x).detach()


class LowerPrecision(TorchFunctionMode):
    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                listed = len(args) == 2 and isinstance(args[1], (list, tuple))
                ops = args[1] if listed else args[1:]
                args = (args[0],) + tuple(_round(t, self.kind) for t in ops)
            else:
                args = tuple(_round(a, self.kind) if i < 2 and isinstance(a, torch.Tensor) else a
                             for i, a in enumerate(args))
        return func(*args, **kwargs)
