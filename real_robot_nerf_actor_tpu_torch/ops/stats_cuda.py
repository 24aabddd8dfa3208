"""3-D spatial-softmax statistics in one pass over the volume (CUDA C++).

Counterpart of the JAX package's `ops/stats_pallas.py`: it replaces
`spatial_stats_3d` (the Pallas kernel `_stats_kernel`). For a cubic volume
(B, V, V, V, C) and e = exp((x - max_c) / T) in fp32 it returns (B, C, 4)
fp32 sums [sum e, sum e*lin[y], sum e*lin[z], sum e*lin[x]] at (z, y, x),
lin[i] = i * 2/(V-1) - 1: the reference's meshgrid('xy') order, so the
keypoints num/den equal `ops.spatial_softmax.spatial_softmax_3d`.

What bounds it on this card: it reads the volume once (256 MB for the
policy's fp32 100^3 x 64 d0) and does ~10 flops per element, far below the
card's balance point: memory (3.35 TB/s on H100 SXM) is the limit.

Design (`csrc/spatial_stats.cu`): one read of device memory, nothing
before the kernel and nothing after it. The max is found on the way (an
online softmax): each block streams one slab of rows through a ring of
32 KB shared-memory stages filled by TMA bulk copies, rescales its running
sums where a stage raises a channel's max, and writes one partial (max,
sums) per channel; the last block of each group of 16 slabs folds the
group's partials, and the last of those the groups', in a fixed order.
`plan` picks the route and the slab sizes; rows that are not whole 16
bytes (or C > 2048, or an unaligned base) take plain loads in the same
kernel. `spatial_stats_3d.launches` counts calls that launched,
`cuda_launches` those of this kernel.

`spatial_stats_3d_triton_prev` keeps the first design (a `torch.amax` pass,
a Triton kernel of 64 x 64 tiles, a torch fold of its partials) for
same-run comparisons only; nothing on the main path calls it.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`spatial_stats_3d_plain`, the same function in plain PyTorch. No backward:
the JAX package has no VJP for its kernel, so a CUDA call under grad mode
with an input that requires a gradient raises (`ops._grad.refuse_grad`).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.ops._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/spatial_stats.cu: threads of a block, ring stages, bytes of a stage,
# blocks per SM (two of 512 threads and ~100 KB of shared memory)
THREADS, STAGES, STAGE_BYTES, BLOCKS_PER_SM = 512, 3, 32768, 2
FOLD_GROUP = 16            # slabs whose partials the last of them folds
SMS = 132                  # streaming multiprocessors of an H100 SXM
_SMS_BY_DEVICE = {}
_TICKETS = {}
# the first (Triton) design, kept for same-run comparisons
_BLOCK_R = 64           # rows per tile
_BLOCK_C = 64           # channels per program
_ROWS_PER_PROG = 2048   # rows per slab (a multiple of _BLOCK_R)


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    """How the kernel cuts one call. `rows_side_by_side` rows of a stage run
    side by side, and each thread takes `rows_per_thread` rows of a stage of
    `stage_rows` rows (row r of a stage goes to thread-row
    r % rows_side_by_side). Each batch's rows are cut into `slabs` slabs of
    `rows_per_slab` (a whole number of stages; the last slab shorter), one
    block each per channel group (`groups`: 1 on the bulk route). The
    partials are folded by groups of FOLD_GROUP slabs (`fold_groups` of
    them a batch), then across the groups."""
    bulk: bool
    rows_side_by_side: int
    rows_per_thread: int
    stage_rows: int
    rows_per_slab: int
    slabs: int
    groups: int
    fold_groups: int


@functools.lru_cache(maxsize=256)
def plan(shape, element_size: int, data_ptr: int = 0, sms: int = SMS,
         threads: int = THREADS, stages: int = STAGES, stage_bytes: int = STAGE_BYTES,
         blocks_per_sm: int = BLOCKS_PER_SM) -> StatsPlan:
    """The kernel's cut of a (B, V, V, V, C) volume: the bulk-copy ring when
    a row is whole 16 bytes of channels in fours, C <= 4 * threads and the
    base is 16-byte aligned, else plain loads of one channel a thread in
    groups of `threads` channels; slabs for `blocks_per_sm` blocks on each
    of `sms` SMs, at least one ring of stages each. The last four
    arguments are the kernel's constants (tools/stats_ring.py varies them)."""
    b, v, _, _, c = shape
    n_rows = v ** 3
    bulk = (c % 4 == 0 and c * element_size % 16 == 0 and data_ptr % 16 == 0
            and c // 4 <= threads)
    ch = 4 if bulk else 1
    groups = 1 if bulk else -(-c // threads)
    lanes = c // 4 if bulk else min(c, threads)
    side = threads // lanes
    per_thread = stage_bytes // (threads * ch * element_size)
    stage_rows = side * per_thread
    n_stages = -(-n_rows // stage_rows)
    slabs = max(1, min(sms * blocks_per_sm // (b * groups), -(-n_stages // stages)))
    rows_per_slab = -(-n_stages // slabs) * stage_rows
    slabs = -(-n_rows // rows_per_slab)
    return StatsPlan(bulk, side, per_thread, stage_rows, rows_per_slab, slabs, groups,
                     -(-slabs // FOLD_GROUP))


def spatial_stats_3d_plain(feature: torch.Tensor,
                           temperature: float = 0.01) -> torch.Tensor:
    """(B, V, V, V, C) -> (B, C, 4) fp32, the kernel's arithmetic."""
    b, v, _, _, c = feature.shape
    mx = torch.amax(feature, dim=(1, 2, 3)).float()
    e = torch.exp((feature.float() - mx[:, None, None, None, :])
                  * (1.0 / temperature))
    lin = torch.arange(v, dtype=torch.float32, device=feature.device) \
        * (2.0 / (v - 1)) - 1.0
    s0 = e.sum(dim=(1, 2, 3))
    sy = torch.einsum("byc,y->bc", e.sum(dim=(1, 3)), lin)
    sz = torch.einsum("bzc,z->bc", e.sum(dim=(2, 3)), lin)
    sx = torch.einsum("bxc,x->bc", e.sum(dim=(1, 2)), lin)
    return torch.stack([s0, sy, sz, sx], dim=-1)


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, mx_ptr, out_ptr, n_rows, C, V, n_slabs,
                     rows_per_prog, inv_temp, step,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = pid // n_slabs
        slab = pid % n_slabs
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mx = tl.load(mx_ptr + b * C + cols, mask=cmask, other=0.0)
        s0 = tl.zeros([BLOCK_C], dtype=tl.float32)
        sy = tl.zeros([BLOCK_C], dtype=tl.float32)
        sz = tl.zeros([BLOCK_C], dtype=tl.float32)
        sx = tl.zeros([BLOCK_C], dtype=tl.float32)
        row0 = slab * rows_per_prog
        row_end = tl.minimum(row0 + rows_per_prog, n_rows)
        base = x_ptr + b.to(tl.int64) * n_rows * C
        for r0 in range(row0, row_end, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            rmask = rows < row_end
            mask = rmask[:, None] & cmask[None, :]
            x = tl.load(base + rows.to(tl.int64)[:, None] * C + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            e = tl.exp((x - mx[None, :]) * inv_temp)
            e = tl.where(mask, e, 0.0)
            zi = rows // (V * V)
            yi = (rows // V) % V
            xi = rows % V
            ly = yi.to(tl.float32) * step - 1.0
            lz = zi.to(tl.float32) * step - 1.0
            lx = xi.to(tl.float32) * step - 1.0
            s0 += tl.sum(e, axis=0)
            sy += tl.sum(e * ly[:, None], axis=0)
            sz += tl.sum(e * lz[:, None], axis=0)
            sx += tl.sum(e * lx[:, None], axis=0)
        out = out_ptr + pid * 4 * C + cols
        tl.store(out, s0, mask=cmask)
        tl.store(out + C, sy, mask=cmask)
        tl.store(out + 2 * C, sz, mask=cmask)
        tl.store(out + 3 * C, sx, mask=cmask)

    return stats_kernel


def _check(feature):
    if not feature.is_cuda:
        raise ValueError(f"spatial_stats_3d: need a CUDA tensor, got {feature.device}")
    if feature.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spatial_stats_3d: float32 or bfloat16, got {feature.dtype}")
    if feature.dim() != 5 or not (feature.shape[1] == feature.shape[2]
                                  == feature.shape[3]):
        raise ValueError("spatial_stats_3d: need a cubic (B, V, V, V, C) "
                         f"volume, got {tuple(feature.shape)}")
    if not feature.is_contiguous():
        raise ValueError("spatial_stats_3d: feature must be contiguous")


def spatial_stats_3d_triton_prev(feature: torch.Tensor,
                                 temperature: float = 0.01) -> torch.Tensor:
    """The first CUDA design (for comparisons only): torch.amax, the Triton
    kernel over slabs of 2048 rows, a torch fold of the partials."""
    _check(feature)
    b, v, _, _, c = feature.shape
    n_rows = v * v * v
    n_slabs = -(-n_rows // _ROWS_PER_PROG)
    mx = torch.amax(feature, dim=(1, 2, 3)).float().contiguous()
    partials = torch.empty((b * n_slabs, 4, c), dtype=torch.float32,
                           device=feature.device)
    grid = (b * n_slabs, -(-c // _BLOCK_C))
    with torch.cuda.device(feature.device):
        _triton_kernel()[grid](feature, mx, partials, n_rows, c, v, n_slabs,
                               _ROWS_PER_PROG, 1.0 / temperature, 2.0 / (v - 1),
                               BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C, num_warps=4)
    return partials.reshape(b, n_slabs, 4, c).sum(dim=1).transpose(1, 2)


def spatial_stats_3d(feature: torch.Tensor,
                     temperature: float = 0.01) -> torch.Tensor:
    """feature: (B, V, V, V, C) bf16/f32 -> (B, C, 4) fp32 sums
    [denominator, lin[y], lin[z], lin[x] numerators]."""
    if feature.device.type == "cpu":
        return spatial_stats_3d_plain(feature, temperature)
    refuse_grad("spatial_stats_3d", 'stats_backend="xla"', feature)
    return _launch(feature, temperature)


def _launch(feature, temperature):
    """Check the CUDA input, launch the kernel for it, count it."""
    _check(feature)
    b, v, _, _, c = feature.shape
    if v ** 3 >= 2 ** 31:
        raise ValueError(f"spatial_stats_3d: {v}^3 rows do not fit the kernel's int32 rows")
    dev = feature.device
    sms = _SMS_BY_DEVICE.get(dev.index)
    if sms is None:
        sms = _SMS_BY_DEVICE[dev.index] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    pl = plan(tuple(feature.shape), feature.element_size(), feature.data_ptr() % 16, sms)
    # one allocation: the output, then the (m, sums) of each slab and of each
    # group of slabs (16-byte aligned after the (B, C, 4) output)
    buf = torch.empty(4 * b * c + 5 * b * c * (pl.slabs + pl.fold_groups),
                      dtype=torch.float32, device=dev)
    out, scratch = buf[:4 * b * c].view(b, c, 4), buf[4 * b * c:]
    lib = _build.load("spatial_stats")

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_tickets = b * pl.fold_groups + 1
        tickets = _TICKETS.get((dev.index, stream))
        if tickets is None or tickets.numel() < n_tickets:
            # zeroed once; the kernel leaves them zero
            tickets = _TICKETS[(dev.index, stream)] = torch.zeros(
                max(n_tickets, 1024), dtype=torch.int32, device=dev)
        return lib.spatial_stats_3d_fwd(
            feature.data_ptr(), scratch.data_ptr(), out.data_ptr(), tickets.data_ptr(),
            b, v, c, _DTYPES[feature.dtype], int(pl.bulk), pl.rows_per_slab, pl.slabs,
            pl.groups, FOLD_GROUP, math.log2(math.e) / temperature, 2.0 / (v - 1), stream)

    if dev.index == torch.cuda.current_device():
        code = launch()
    else:                       # the launch goes to the current device
        with torch.cuda.device(dev):
            code = launch()
    _build.check(lib, code, "spatial_stats_3d")
    spatial_stats_3d.launches += 1
    spatial_stats_3d.cuda_launches += 1
    spatial_stats_3d.last_plan = pl
    return out


spatial_stats_3d.launches = 0        # calls that launched a kernel
spatial_stats_3d.cuda_launches = 0   # of those, launches of csrc/spatial_stats.cu
spatial_stats_3d.last_plan = None    # the StatsPlan of the last launch


def spatial_softmax_3d_pallas(feature: torch.Tensor,
                              temperature: float = 0.01) -> torch.Tensor:
    """Drop-in for ops.spatial_softmax.spatial_softmax_3d on cubic volumes,
    through `spatial_stats_3d` (the name keeps the JAX knob's)."""
    b, _, _, _, c = feature.shape
    sums = spatial_stats_3d(feature, temperature)
    kp = sums[..., 1:] / sums[..., :1]
    return kp.reshape(b, c * 3)
