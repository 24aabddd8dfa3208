"""Build and load the package's CUDA C++ kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, at first use, into `.build/` beside this
package (git-ignored). The file name carries a hash of the source, the
shared headers and the flags, so an edited source is rebuilt and an
unchanged one is reused. Libraries are loaded with `ctypes`: pointers and
the stream go in as `c_void_p`, and every entry point returns the launch's
`cudaGetLastError()` code, which `check` turns into an exception.

`build_all` starts one `nvcc` per source, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

# ctypes signatures of the C entry points, by source name
_SIGNATURES = {
    "flash_attention": {
        # q, k, v, o, part_o, part_ml; nb, heads, nq, nk, splits,
        # tiles_per_split; 12 element strides; scale, dtype, stream
        "flash_attention_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p],
    },
    "conv3d_k3": {
        "conv3d_k3_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_int, ctypes.c_void_p],
        # x, w, bias, out; nb, d, h, w, cin, cout; stream (bf16 only)
        "conv3d_k3_wgmma_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_void_p],
    },
    "spatial_stats": {
        # x, scratch, out, tickets; B, V, C, dtype, bulk, rows_per_slab, slabs,
        # groups, fold_group; k, step; stream
        "spatial_stats_3d_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    },
    "resnetfc_int8": {
        # zi, 10 weight/scale pointers, out, hidden; n, d_latent, n_aux,
        # d_hidden, n_blocks, combine_layer, k_in, k_lat, quantized, design;
        # stream
        "resnetfc_int8_fwd": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
        + [ctypes.c_void_p],
        # vox, flat, w8, aux, 10 weight/scale pointers, out, hidden; the same
        # ints, vox_f32 and design; stream
        "gather_resnetfc_int8_fwd": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11
        + [ctypes.c_void_p],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of this package are built at "
            "first use and need the CUDA toolkit (nvcc on PATH or under "
            "/usr/local/cuda)")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                           + log.decode(errors="replace"))
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(_SIGNATURES)) -> float:
    """Compile the named sources in parallel (one nvcc each); returns the
    wall seconds taken. Already-built libraries are reused."""
    names = list(names)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    jobs: List = [_start(n, nvcc) for n in names]
    for n, job in zip(names, jobs):
        _finish(n, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({code})")
