"""The import guard: no JAX, and not the JAX package, in the process."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "real_robot_nerf_actor_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among `names` (default: sys.modules),
    compared whole: `real_robot_nerf_actor_tpu_torch` is not
    `real_robot_nerf_actor_tpu`."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
