"""Where the port's compiled kernels are kept (counterpart of the JAX
package's `utils/cache.py`, which points XLA's persistent compilation
cache at a directory). What the port compiles is its CUDA C++ kernels:
`ops/_build.py` builds each `csrc/*.cu` once, into a file named by a hash
of its source and flags, and reuses it. This function points that build
directory elsewhere, e.g. at a disk that outlives the checkout.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from real_robot_nerf_actor_tpu_torch.ops import _build


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load the kernels from `cache_dir` (created if missing;
    idempotent), or, with None, from the build directory in use (by default
    the package's git-ignored `.build/`). Returns the directory. Libraries
    already loaded stay loaded; the next kernel load builds there, or reuses
    what is there."""
    if cache_dir is not None:
        _build.BUILD_DIR = Path(cache_dir)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    return str(_build.BUILD_DIR)
