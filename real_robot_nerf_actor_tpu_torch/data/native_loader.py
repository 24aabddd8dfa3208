"""ctypes bindings of the native PLY loader and prefetcher (the port's
counterpart of the JAX package's `data/native_loader.py`).

The C++ source is the port's own copy, `csrc/ply_loader.cpp`. It is
compiled with `g++` at first use into the package's git-ignored `.build/`
directory, under a name that carries a hash of the source and the flags, so
an edited source is rebuilt. A failed build raises: nothing falls back to
the Python reader (`data/ply.py`), which stays the reference the tests hold
the native parser to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from real_robot_nerf_actor_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent.parent / "csrc" / "ply_loader.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libply_loader_{h}.so"


def build() -> Path:
    """The shared library, compiled first if this source has not been.
    Raises RuntimeError when g++ is missing or the compile fails."""
    so = _lib_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native PLY loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{out.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent build finds a whole file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        fp = ctypes.POINTER(ctypes.c_float)
        lib.ply_load.restype = ctypes.c_long
        lib.ply_load.argtypes = [ctypes.c_char_p, ctypes.c_long, fp, fp]
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_long]
        lib.loader_submit.restype = None
        lib.loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_double)]
        lib.loader_next.restype = ctypes.c_long
        lib.loader_next.argtypes = [ctypes.c_void_p, fp, fp,
                                    ctypes.POINTER(ctypes.c_uint8)]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native loader builds (or is built) and loads here. Never
    raises: the loader itself still raises on a failed build."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_ply_native(path: str, max_pts: int = 1 << 20
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """`data.ply.read_ply` through the native parser: (points (N,3),
    colors (N,3) in [0,1], zeros where the file has none), at most max_pts
    points."""
    lib = get_lib()
    xyz = np.empty((max_pts, 3), np.float32)
    rgb = np.empty((max_pts, 3), np.float32)
    n = lib.ply_load(path.encode(), max_pts, _fptr(xyz), _fptr(rgb))
    if n < 0:
        raise IOError(f"native PLY parse failed: {path}")
    return xyz[:n].copy(), rgb[:n].copy()


class NativePrefetcher:
    """Asynchronous point-cloud loader: submit paths ahead, pop padded
    (points, colors, valid) in FIFO order off the training loop's critical
    path. The native side drops points at ||p|| >= 3 m, applies cam2base
    and maps rgb to [-1, 1], as `data/replay.load_rgb_pcd` does."""

    def __init__(self, max_num_coords: int, n_workers: int = 2, capacity: int = 8):
        self._lib = get_lib()
        self.max_pts = max_num_coords
        self._handle = self._lib.loader_create(n_workers, max_num_coords, capacity)

    def submit(self, path: str, cam2base: Optional[np.ndarray] = None):
        ptr = None
        if cam2base is not None:
            tf = np.ascontiguousarray(cam2base, np.float64).reshape(16)
            ptr = tf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._lib.loader_submit(self._handle, path.encode(), ptr)

    def next(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        xyz = np.empty((self.max_pts, 3), np.float32)
        rgb = np.empty((self.max_pts, 3), np.float32)
        valid = np.empty((self.max_pts,), np.uint8)
        self._lib.loader_next(self._handle, _fptr(xyz), _fptr(rgb),
                              valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return xyz, rgb, valid.astype(bool)

    def close(self):
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativePrefetcher":
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
