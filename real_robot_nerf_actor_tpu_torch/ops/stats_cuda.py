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
kernel. `spatial_stats_3d.launches` counts its launches.

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

    def launch(stream):
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

    _build.check(lib, _build.on_device(dev, launch), "spatial_stats_3d")
    spatial_stats_3d.launches += 1
    spatial_stats_3d.last_plan = pl
    return out


spatial_stats_3d.launches = 0        # launches of csrc/spatial_stats.cu
spatial_stats_3d.last_plan = None    # the StatsPlan of the last launch


def spatial_softmax_3d_pallas(feature: torch.Tensor,
                              temperature: float = 0.01) -> torch.Tensor:
    """Drop-in for ops.spatial_softmax.spatial_softmax_3d on cubic volumes,
    through `spatial_stats_3d` (the name keeps the JAX knob's)."""
    b, _, _, _, c = feature.shape
    sums = spatial_stats_3d(feature, temperature)
    kp = sums[..., 1:] / sums[..., :1]
    return kp.reshape(b, c * 3)
