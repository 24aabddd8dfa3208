"""The control of an fp32 cell: the reference computed in TF32, the step
below fp32 on an H100 (10 bits of mantissa in the tensor cores' products,
fp32 sums). Inside `TF32(device)` a CUDA device runs every matrix product
and convolution in TF32 (torch's two flags on, restored after); elsewhere,
where no TF32 unit exists, each product's two operands are rounded to TF32
(nearest, ties to even) and multiplied in fp32, which is what a TF32 unit
computes up to its order of sums."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# the products the references call (`a @ b` arrives as Tensor.matmul)
_PRODUCTS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul, torch.einsum,
             torch.tensordot}
_DROP = 13    # fp32's 23 mantissa bits less TF32's 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to the nearest TF32 value, ties to even, as fp32;
    gradients pass straight through."""
    if x.dtype != torch.float32:
        return x
    b = x.detach().contiguous().view(torch.int32)
    half = (1 << (_DROP - 1)) - 1
    b = (b + half + ((b >> _DROP) & 1)) & ~((1 << _DROP) - 1)
    d = (b.view(torch.float32) - x.detach()).nan_to_num(0.0, 0.0, 0.0)
    return x + d


class _Rounded(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                listed = len(args) == 2 and isinstance(args[1], (list, tuple))
                ops = args[1] if listed else args[1:]
                args = (args[0],) + tuple(round_tf32(t) for t in ops)
            else:
                args = tuple(round_tf32(a) if i < 2 and isinstance(a, torch.Tensor) else a
                             for i, a in enumerate(args))
        return func(*args, **kwargs)


class TF32:
    """Products in TF32 on `device` for the block (see the module's note)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            self.mode = _Rounded()
            self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        else:
            self.mode.__exit__(*exc)
        return False
