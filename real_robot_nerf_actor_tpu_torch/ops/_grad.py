"""The gradient rule of the kernel wrappers that have no backward.

The JAX package differentiates two of its Pallas kernels (`conv3d_k3`,
`corner_lerp`) through custom VJPs; the port's wrappers of those two are
`torch.autograd.Function`s. The other five (`flash_attention`,
`spatial_stats_3d`, `ray_expand`, `fused_resnetfc_int8`,
`fused_gather_resnetfc_int8`) have no VJP in the reference: `pallas_call`
has no autodiff, and the quantized field fails fast on a backward. Their
CUDA branches call `refuse_grad` before anything else, so a training run
with one of their knobs on stops with an error instead of getting no
gradient for what reaches the loss only through the kernel. On a CPU tensor
they run their plain, differentiable versions.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, knob: str, *tensors) -> None:
    """Raise if autograd would have to differentiate kernel `name`: grad
    mode is on and one of `tensors` (None entries are skipped) requires a
    gradient. `knob` is the config setting that takes the plain path. Does
    nothing under `torch.no_grad()` or `torch.inference_mode()`."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (the JAX reference has "
            f"no VJP for it either), and an input requires a gradient. Set "
            f"{knob} to train through the plain path, or call it under "
            "torch.no_grad() or torch.inference_mode()")
