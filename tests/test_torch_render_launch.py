"""The host paths of the serving renderer's two CUDA kernels, `ray_expand`
(csrc/ray_expand.cu) and `corner_lerp` (csrc/corner_lerp.cu), on the CPU.

The loaded library is replaced by a recorder (`_build.load`) and the
stream by a fixed handle (`_build.on_device`), so each wrapper's launch
runs here on CPU tensors up to the call into C. The tests hold:
  - the argument list against `_build._SIGNATURES` and the signature
    against the `extern "C"` entry point in the source: pointers in order,
    then ints, then fp32 floats, then the stream;
  - ray_expand's constants, rounded as `_consts` rounds them, and their
    cache (one miss, then hits);
  - the refusals before any launch: an unpadded batch, a tensor that is on
    neither the CPU nor a CUDA device, an input that requires a gradient;
  - corner_lerp's choice of path, and that it enters its autograd.Function
    only where a gradient is wanted.
Nothing here needs a card; the kernels themselves are held against their
plain versions in tests/test_torch_kernels_cuda.py.
"""
import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu_torch.ops import _build, lerp_cuda, ray_expand_cuda

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
STREAM = 0x5EED
ROOT = Path(__file__).resolve().parent.parent


class Recorder:
    """Stands in for a loaded library: records each entry point's call and
    returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.fixture
def lib(monkeypatch):
    rec = Recorder()
    loaded = []
    monkeypatch.setattr(_build, "load", lambda name: loaded.append(name) or rec)
    monkeypatch.setattr(_build, "on_device", lambda dev, launch: launch(STREAM))
    rec.loaded = loaded
    return rec


def _check_types(name, fn, args):
    """Each argument is of the Python type its ctypes type takes, and
    converts to it."""
    argtypes = _build._SIGNATURES[name][fn]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        want = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_float: float}[t]
        assert type(a) is want, (a, t)
        t(a)


def _rays(r, k, seed=0):
    rng = np.random.default_rng(seed)
    rays = rng.standard_normal((r, 8)).astype(np.float32)
    z = rng.uniform(0, 1, (r, k)).astype(np.float32)
    return torch.from_numpy(rays), torch.from_numpy(z)


# ------------------------------------------------------------ signatures
_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_the_sources(name):
    """Each ctypes signature against its `extern "C"` entry point: the
    same functions, and each parameter a pointer, an int or a float in the
    same place."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    entries = {fn: params for fn, params in _ENTRY.findall(src)}
    assert set(entries) == set(_build._SIGNATURES[name])
    for fn, argtypes in _build._SIGNATURES[name].items():
        kinds = []
        for p in entries[fn].split(","):
            p = " ".join(p.split())
            kinds.append(ctypes.c_void_p if "*" in p else
                         ctypes.c_float if p.startswith("float") else ctypes.c_int)
        want = [ctypes.c_void_p if t is ctypes.POINTER(ctypes.c_longlong) else t
                for t in argtypes]
        assert kinds == want, fn


def test_the_port_builds_its_kernels_by_one_route():
    """No module of the port, and not chip_smoke.py, imports triton: every
    kernel is CUDA C++ built by ops/_build.py."""
    files = list((ROOT / "real_robot_nerf_actor_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        assert not re.search(r"^\s*(import|from) triton", f.read_text(), re.M), f


# ------------------------------------------------------------ ray_expand
@pytest.mark.parametrize("r,k,nf,ff", [(256, 16, 6, 1.5), (512, 3, 4, 0.7)])
def test_ray_expand_launch_arguments(lib, monkeypatch, r, k, nf, ff):
    monkeypatch.setattr(ray_expand_cuda, "_check", lambda *a: None)
    rays, z = _rays(r, k)
    dims = (6, 7, 9)
    launches = ray_expand_cuda.ray_expand.launches
    aux, w8, flat = ray_expand_cuda._launch(rays, z, dims, BOUNDS, nf, ff)
    assert lib.loaded == ["ray_expand"]
    [(fn, args)] = lib.calls
    assert fn == "ray_expand_fwd"
    _check_types("ray_expand", fn, args)
    assert args[:5] == tuple(t.data_ptr() for t in (rays, z, aux, w8, flat))
    assert args[5:11] == (r, k, 6, 7, 9, nf)
    lo, ext, _ = ray_expand_cuda._consts(BOUNDS, nf, ff)
    floats = args[11:19]
    assert floats == tuple(float(v) for v in (*lo, *ext, np.float32(ff),
                                              np.float32(2 * math.pi)))
    assert all(float(np.float32(v)) == v for v in floats)   # fp32 values, passed exactly
    if nf:      # the kernel doubles the first factor; _consts rounds each
        assert [floats[6] * 2.0 ** f for f in range(nf)] == [float(v) for v in
                                                             ray_expand_cuda._consts(
                                                                 BOUNDS, nf, ff)[2]]
    assert args[19] == STREAM
    assert (aux.shape, aux.dtype) == ((6 + 3 * nf, k, r), torch.bfloat16)
    assert (w8.shape, w8.dtype) == ((8, k, r), torch.float32)
    assert (flat.shape, flat.dtype) == ((k, r), torch.int32)
    assert ray_expand_cuda.ray_expand.launches == launches + 1


def test_ray_expand_constants_are_cached(lib, monkeypatch):
    monkeypatch.setattr(ray_expand_cuda, "_check", lambda *a: None)
    ray_expand_cuda.launch_consts.cache_clear()
    rays, z = _rays(256, 4)
    for _ in range(3):
        ray_expand_cuda._launch(rays, z, [6, 7, 9], list(BOUNDS), 6, 1.5)
    info = ray_expand_cuda.launch_consts.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    assert len(lib.calls) == 3 and lib.calls[0][1][5:] == lib.calls[2][1][5:]


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("case,error,match", [
    ("unpadded", ValueError, "multiple of 256"),
    ("meta", ValueError, "CUDA"),
    ("grad", RuntimeError, "requires a gradient"),
])
def test_ray_expand_refusals(lib, case, error, match):
    """Each refused before the library is loaded or called."""
    if case == "unpadded":
        rays, z = _rays(200, 4)
    else:
        rays, z = _meta(256, 8), _meta(256, 4, grad=case == "grad")
    with pytest.raises(error, match=match):
        ray_expand_cuda.ray_expand(rays, z, (4, 4, 4), BOUNDS)
    assert lib.calls == [] and lib.loaded == []


# ------------------------------------------------------------ corner_lerp
@pytest.mark.parametrize("dtype,c,odd,vector", [(torch.bfloat16, 64, False, 1),
                                                (torch.float32, 64, False, 1),
                                                (torch.bfloat16, 12, False, 0),
                                                (torch.float32, 6, False, 0),
                                                (torch.bfloat16, 64, True, 0)])
def test_corner_lerp_launch_arguments(lib, dtype, c, odd, vector):
    m = 100
    src = torch.zeros(m * 8 * c + 8, dtype=dtype)
    rows = src[1 if odd else 0:][:m * 8 * c].view(m, 8 * c)
    assert (src.data_ptr() % 16, rows.is_contiguous()) == (0, True)
    w = torch.zeros((8, m))
    launches = lerp_cuda.corner_lerp.launches
    out = lerp_cuda._launch(rows, w)
    assert lib.loaded == ["corner_lerp"]
    [(fn, args)] = lib.calls
    assert fn == "corner_lerp_fwd"
    _check_types("corner_lerp", fn, args)
    assert args == (rows.data_ptr(), w.data_ptr(), out.data_ptr(), m, c,
                    {torch.float32: 0, torch.bfloat16: 1}[dtype], vector, STREAM)
    assert (out.shape, out.dtype) == ((m, c), dtype)
    assert lerp_cuda.corner_lerp.launches == launches + 1


def test_corner_lerp_refuses_a_meta_tensor(lib):
    with pytest.raises(ValueError, match="CUDA"):
        lerp_cuda.corner_lerp(_meta(4, 64), _meta(8, 4))
    assert lib.calls == [] and lib.loaded == []


@pytest.mark.parametrize("rows_grad,no_grad,function", [(False, False, False),
                                                        (True, True, False),
                                                        (True, False, True)])
def test_corner_lerp_enters_its_function_only_for_a_gradient(monkeypatch, rows_grad,
                                                             no_grad, function):
    """Where no gradient can flow the wrapper launches directly, with no
    autograd.Function around the launch; under grad mode with an input
    that requires one, the Function records its backward."""
    monkeypatch.setattr(lerp_cuda, "_check", lambda *a: None)
    launched = []
    monkeypatch.setattr(lerp_cuda, "_launch",
                        lambda rows, w: launched.append(1) or torch.empty((4, 8), device="meta"))
    rows = _meta(4, 64, grad=rows_grad)
    with torch.set_grad_enabled(not no_grad):
        y = lerp_cuda.corner_lerp(rows, _meta(8, 4))
    assert launched == [1]
    name = type(y.grad_fn).__name__ if y.grad_fn is not None else None
    assert name == ("CornerLerpBackward" if function else None)
