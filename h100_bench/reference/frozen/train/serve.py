"""The one helper of the port's `train/serve.py` that the frozen renderer
uses."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev
