"""Weight gradient of a 3-D convolution over NDHWC tensors (CUDA C++), and
the convs of `models/blocks.py` whose backward takes it.

Replaces no TPU kernel: the JAX package leaves the policy UNet's backward
(`MultiLayer3DEncoderShallow`, `MultiLayer3DEncoder`) to XLA. It was added
because cuDNN computes the weight gradients of these fp32 convolutions at
batch 1, a reduction over up to 10^6 voxels at 8-64 channels, with a grouped
direct kernel that leaves most of the card idle: about 44 ms of each joint
train step on an H100, against a bound of about 0.24 ms for all eleven.

For S (N, Dp, Hp, Wp, A), L (N, Dl, Hl, Wl, B) and the taps t of a k^3
kernel,

    dW[a, b, t] = sum_p S[p, a] * L[stride * p + t - pad, b]

with L zero outside its volume, returned in torch's weight layout (A, B, k,
k, k). A conv of stride s and padding pad takes S = its output gradient and
L = its input (dW is its (Cout, Cin, k, k, k) weight's gradient); a
transposed conv takes S = its input and L = the gradient of its whole
output ((Cin, Cout, k, k, k)).

What bounds it on this card: 2 A B k^3 flops a position of S against A + B
elements read, fp32 FMA at 67 TF/s (float64 34 TF/s); bytes at 3.35 TB/s
only for the 1x1 head. Design (`csrc/conv3d_wgrad.cu`): an implicit GEMM in
FFMA split over positions. Persistent blocks walk bricks of S positions,
each staged with its halo of L in shared memory by cp.async (double
buffered); a thread owns 8 x 4 of dW at one tap; `tiling` picks the tile
and the brick from the shape (a dW wider than one block's 256 thread tiles
is split over blockIdx.y). Each block writes its partial dW to scratch the
wrapper allocates, and a second launch sums the partials in a fixed order:
no atomics, two calls bit-equal.

On a CUDA tensor `conv3d_wgrad` launches the kernel (fp32 or float64) or
raises; on a CPU tensor it runs `conv3d_wgrad_plain`, one product of the
positions' rows a tap. `conv3d_wgrad.launches` counts its calls on the card
(two launches each).

`conv3d` and `conv_transpose3d` are `F.conv3d` and `F.conv_transpose3d`
over NCDHW views, and every `Conv3d` and `ConvTranspose3d` of
`models/blocks.py` calls them: the route is taken here alone, from what a
call shows. Where x is fp32 or float64, grad mode is on and the weight or
the bias needs a gradient, the call runs in `Conv3dWgrad`, whose backward,
under the span `backward.unet_conv`, takes dx from cuDNN's data gradient
alone (skipped where x needs none), dW from `conv3d_wgrad` and db as the
output gradient's sum; that backward is differentiable once (a second
order raises). Any other dtype (the bf16 policy convs), and every call
without grad (the act paths), is the plain torch call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope

_DTYPES = {torch.float32: 0, torch.float64: 2}
RA, RB = 8, 4              # a thread's tile of dW: channels of A by channels of B
THREADS = 256              # threads of a block at most (thread tiles x groups)
STAGE_BYTES = 48 * 1024    # one stage of a brick in shared memory at most


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv3d_wgrad_plain(s: torch.Tensor, l: torch.Tensor, k: int, stride: int,
                       pad: int) -> torch.Tensor:
    """dW (A, B, k, k, k) in s's dtype: for each tap, S's rows (P, A)
    transposed times L's strided slice at that tap (P, B), L zero-padded."""
    _, dp, hp, wp, a = s.shape
    b = l.shape[-1]
    pads = []
    for n_s, n_l in zip((dp, hp, wp), l.shape[1:4]):
        pads += [pad, max(0, stride * (n_s - 1) + k - pad - n_l)]
    lp = F.pad(l, (0, 0, *pads[4:6], *pads[2:4], *pads[0:2]))
    st = s.reshape(-1, a).T
    out = s.new_empty((a, b, k, k, k))
    for tz in range(k):
        for ty in range(k):
            for tx in range(k):
                lt = lp[:, tz:tz + stride * (dp - 1) + 1:stride,
                        ty:ty + stride * (hp - 1) + 1:stride,
                        tx:tx + stride * (wp - 1) + 1:stride]
                out[:, :, tz, ty, tx] = st @ lt.reshape(-1, b)
    return out


def _stage_bytes(brick, ta, tb, k, stride, size) -> int:
    npos = brick[0] * brick[1] * brick[2]
    hpos = 1
    for n in brick:
        hpos *= stride * (n - 1) + k
    return _up((npos * ta + hpos * tb) * size + npos * 8, 16)


def tiling(a: int, b: int, k: int, dims, stride: int, size: int):
    """(ta, tb, groups, brick) of the kernel for A and B channels, a k^3
    kernel, S of spatial `dims`, `stride` and elements of `size` bytes:
    the widest tile of dW whose thread tiles (every tap, 8 x 4 channels
    each) fit a block, halving its wider side until they do; `groups`
    threads a thread tile; a brick of 256 positions at stride 1 (64 at
    stride 2, whose halo is 8x larger) cut to the volume, halved until a
    stage fits STAGE_BYTES."""
    taps = k ** 3
    if taps > THREADS:
        raise ValueError(f"conv3d_wgrad: a {k}^3 kernel has more taps than a block's "
                         f"{THREADS} threads")
    ta, tb = _up(a, RA), _up(b, RB)
    while taps * (ta // RA) * (tb // RB) > THREADS:
        if ta // RA >= tb // RB:
            ta = _up(ta // 2, RA)
        else:
            tb = _up(tb // 2, RB)
    groups = THREADS // (taps * (ta // RA) * (tb // RB))
    brick = [min(n, m) for n, m in zip(dims, (2, 8, 16) if stride == 1 else (1, 4, 16))]
    while _stage_bytes(brick, ta, tb, k, stride, size) > STAGE_BYTES:
        i = 0 if brick[0] > 1 else 1 if brick[1] > 1 else 2
        if brick[i] == 1:
            raise ValueError("conv3d_wgrad: one position's stage does not fit a block")
        brick[i] = -(-brick[i] // 2)
    return ta, tb, groups, tuple(brick)


@dataclasses.dataclass(frozen=True)
class Plan:
    ta: int
    tb: int
    groups: int
    brick: Tuple[int, int, int]
    grid_x: int      # persistent blocks a tile of dW: rows of the partials


@functools.lru_cache(maxsize=256)
def plan(n: int, dims: Tuple[int, int, int], a: int, b: int, k: int, stride: int,
         dtype: torch.dtype, vec: int, device: int) -> Plan:
    """The launch of a call: its tiling, and as many blocks a tile as fill
    the card (its SMs times the blocks one holds, by the occupancy API),
    at most one a brick."""
    ta, tb, groups, brick = tiling(a, b, k, dims, stride, torch.finfo(dtype).bits // 8)
    lib = _build.load("conv3d_wgrad")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.conv3d_wgrad_occupancy(k, stride, *brick, ta, tb, groups, _DTYPES[dtype],
                                          vec, ctypes.addressof(per_sm))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    _build.check(lib, code, "conv3d_wgrad")
    tiles = -(-a // ta) * -(-b // tb)
    bricks = n * -(-dims[0] // brick[0]) * -(-dims[1] // brick[1]) * -(-dims[2] // brick[2])
    grid_x = min(bricks, max(1, -(-sms * max(per_sm.value, 1) // tiles)))
    return Plan(ta, tb, groups, brick, grid_x)


def _vec(s: torch.Tensor, l: torch.Tensor) -> int:
    """Elements of one copy into shared memory: the widest of 16, 8 or 4
    bytes that divides both channel counts and both bases' alignment."""
    size = s.element_size()
    for v in (4, 2, 1):
        if (v * size <= 16 and s.shape[-1] % v == 0 and l.shape[-1] % v == 0
                and s.data_ptr() % (v * size) == 0 and l.data_ptr() % (v * size) == 0):
            return v
    return 1


def _check(s, l, k, stride, pad):
    if not (s.is_cuda and l.is_cuda) or s.device != l.device:
        raise ValueError("conv3d_wgrad: s and l must lie on one CUDA device")
    if s.dtype not in _DTYPES or l.dtype != s.dtype:
        raise TypeError(f"conv3d_wgrad: s and l must be both float32 or both float64, got "
                        f"{s.dtype}, {l.dtype}")
    if s.dim() != 5 or l.dim() != 5 or s.shape[0] != l.shape[0]:
        raise ValueError(f"conv3d_wgrad: bad shapes {tuple(s.shape)}, {tuple(l.shape)}")
    if not (s.is_contiguous() and l.is_contiguous()):
        raise ValueError("conv3d_wgrad: s and l must be contiguous (NDHWC)")
    if k < 1 or stride < 1 or pad < 0:
        raise ValueError(f"conv3d_wgrad: bad k {k}, stride {stride}, pad {pad}")


def conv3d_wgrad(s: torch.Tensor, l: torch.Tensor, k: int, stride: int = 1,
                 pad: int = 0) -> torch.Tensor:
    """s (N, Dp, Hp, Wp, A), l (N, Dl, Hl, Wl, B) NDHWC, fp32 or float64 ->
    dW (A, B, k, k, k) in their dtype (see the module's note)."""
    if s.device.type == "cpu":
        return conv3d_wgrad_plain(s, l, k, stride, pad)
    _check(s, l, k, stride, pad)
    n, dp, hp, wp, a = s.shape
    _, dl, hl, wl, b = l.shape
    vec = _vec(s, l)
    pl = plan(n, (dp, hp, wp), a, b, k, stride, s.dtype, vec, s.device.index)
    part = torch.empty(pl.grid_x * a * b * k ** 3, dtype=s.dtype, device=s.device)
    out = torch.empty((a, b, k, k, k), dtype=s.dtype, device=s.device)
    lib = _build.load("conv3d_wgrad")
    code = _build.on_device(s.device, lambda stream: lib.conv3d_wgrad_fwd(
        s.data_ptr(), l.data_ptr(), part.data_ptr(), out.data_ptr(), n, dp, hp, wp, a,
        dl, hl, wl, b, k, stride, pad, *pl.brick, pl.ta, pl.tb, pl.groups, pl.grid_x,
        _DTYPES[s.dtype], vec, stream))
    _build.check(lib, code, "conv3d_wgrad")
    conv3d_wgrad.launches += 1
    return out


conv3d_wgrad.launches = 0   # calls of csrc/conv3d_wgrad.cu on the card (two launches each)


class Conv3dWgrad(torch.autograd.Function):
    """F.conv3d, or F.conv_transpose3d where `transposed`, over NCDHW views
    of NDHWC tensors; the backward computes dW with `conv3d_wgrad`."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, transposed):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, transposed)
        if transposed:
            return F.conv_transpose3d(x, weight, bias, stride=stride, padding=padding)
        return F.conv3d(x, weight, bias, stride=stride, padding=padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, transposed = ctx.conv
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        with named_scope("backward.unet_conv"):
            if need_x:
                dx = torch.ops.aten.convolution_backward(
                    g, x, weight, None, (stride,) * 3, (padding,) * 3, (1, 1, 1), transposed,
                    (0, 0, 0), 1, (True, False, False))[0]
            if need_w:
                gl = g.permute(0, 2, 3, 4, 1).contiguous()
                xl = x.permute(0, 2, 3, 4, 1).contiguous()
                s, l = (xl, gl) if transposed else (gl, xl)
                dw = conv3d_wgrad(s, l, weight.shape[-1], stride, padding)
            if need_b:
                db = g.sum(dim=(0, 2, 3, 4))
        return dx, dw, db, None, None, None


def _takes_function(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> bool:
    return (x.dtype in _DTYPES and torch.is_grad_enabled()
            and (weight.requires_grad or (bias is not None and bias.requires_grad)))


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """F.conv3d(x, weight, bias, stride, padding) on NCDHW x, its weight's
    gradient by `conv3d_wgrad` (see the module's note)."""
    if _takes_function(x, weight, bias):
        return Conv3dWgrad.apply(x, weight, bias, stride, padding, False)
    return F.conv3d(x, weight, bias, stride=stride, padding=padding)


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    """F.conv_transpose3d(x, weight, bias, stride) on NCDHW x, its weight's
    gradient by `conv3d_wgrad` (see the module's note)."""
    if _takes_function(x, weight, bias):
        return Conv3dWgrad.apply(x, weight, bias, stride, 0, True)
    return F.conv_transpose3d(x, weight, bias, stride=stride)
