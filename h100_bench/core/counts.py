"""Operations and bytes of each port kernel's launch, from its shapes (the
kernel table's counts, frozen here), and a model's operations by dtype,
counted from the reference's matrix products on the meta device (no data,
no compute). Each input byte is counted read once and each output byte
written once; operations are what the inputs need."""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch

Work = Tuple[Dict[str, float], float]   # (operations by dtype, bytes)


def conv3d_k3(b: int, d: int, h: int, w: int, cin: int, cout: int) -> Work:
    """The k3 conv's forward, bf16 in and out, fp32 bias."""
    vox = b * d * h * w
    return ({"bfloat16": 2.0 * vox * 27 * cin * cout},
            vox * cin * 2 + 27 * cin * cout * 2 + cout * 4 + vox * cout * 2)


def corner_lerp(m: int, c: int) -> Work:
    """M rows of 8 corners x C bf16 channels and (8, M) fp32 weights to
    (M, C) bf16: 8 products and 8 sums an output."""
    return ({"float32": 16.0 * m * c}, m * 8 * c * 2 + 8 * m * 4 + m * c * 2)


def ray_expand(r: int, k: int, num_freqs: int = 6) -> Work:
    """R rays x K samples to the aux rows (6 + 3F, bf16), corner weights
    (8, fp32) and flat indices (int32)."""
    n = r * k
    aux = 6 + 3 * num_freqs
    return ({"float32": 120.0 * n}, r * 8 * 4 + n * 4 + n * (aux * 2 + 8 * 4 + 4))


def resnetfc_int8(n: int, d_hidden: int = 512, n_blocks: int = 5, combine_layer: int = 3,
                  d_latent: int = 64, num_freqs: int = 6) -> Work:
    """The fused int8 field on N packed rows: the block products in int8,
    the input layer, the latent injections and the head in bf16; rows in
    (N x 128 bf16), out (N x 128 bf16) and hidden (N x d_hidden bf16), and
    the packed weights once."""
    h, nb = d_hidden, n_blocks
    inj = min(combine_layer, nb)
    k_in = -(-3 * (6 + 3 * num_freqs) // 16) * 16
    k_lat = max(16, -(-d_latent // 16) * 16)
    wbytes = (h * k_in * 2 + h * 4 + inj * h * k_lat * 2 + inj * h * 4
              + 2 * nb * h * h + 2 * 2 * nb * h * 4 + 8 * h * 2 + 8 * 4)
    ops = {"int8": n * 2.0 * nb * 2 * h * h,
           "bfloat16": n * 2.0 * h * (k_in + inj * k_lat + 8)}
    return ops, n * 128 * 2 + wbytes + n * (128 + h) * 2


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.ops: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            first = next(a for a in args if isinstance(a, torch.Tensor))
            self.ops[str(first.dtype).split(".")[1]] += count(*args, **kwargs, out_val=out)
        return out


def model_ops(run: Callable[[], None]) -> Dict[str, float]:
    """Operations by dtype of the matrix products and convolutions that
    `run` dispatches (forward and backward), on whatever device its tensors
    live: on the meta device nothing is computed."""
    counter = _Counter()
    with counter:
        run()
    return dict(counter.ops)
