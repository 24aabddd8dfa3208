"""flax variables -> the port's `state_dict`.

The port's modules carry the flax tree's names (see models/blocks.py), so a
leaf at `params/<a>/<b>/<leaf>` (or under `batch_stats`) becomes the
state_dict entry `<a>.<b>.<name>`, with its array rearranged to torch's
layout:

  Dense `kernel` (in, out)                -> `weight` (out, in)
  Conv `kernel` (k, k, k, in, out)        -> `weight` (out, in, k, k, k)
  ConvTranspose `kernel` (k, k, k, in, out) -> `weight` (in, out, k, k, k),
      flipped in all three spatial axes: flax's ConvTranspose does not flip
      its kernel and torch's conv_transpose3d does
  LayerNorm / BatchNorm `scale`           -> `weight`
  BatchNorm `mean` / `var`                -> `running_mean` / `running_var`
  `bias`, `pos_encoding`, `latents`       -> as they are
  `pallas_kernel` / `pallas_bias`         -> as they are: the k3 kernel takes
      the flax (3, 3, 3, Cin, Cout) layout directly

Inputs are numpy arrays (or anything `np.asarray` takes); no JAX needed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path, value: np.ndarray):
    *mods, leaf = path
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 5 and mods and mods[-1].startswith("ConvTranspose"):
            value = value[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {value.ndim}")
        leaf = "weight"
    else:
        leaf = _RENAME.get(leaf, leaf)
    return ".".join([*mods, leaf]), value


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} (nested dicts of arrays) -> a
    state_dict for the port's module of the same architecture."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            name, arr = _convert_leaf(path, np.asarray(value, np.float32))
            out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out
