"""Tensor- and data-parallel collectives at the models' cut points (the
port's counterpart of the JAX package's `parallel/constraints.py`).

In JAX these are layout hints: the models call `shard_hidden` at Megatron
cut points and XLA inserts the one psum per block. Here the same cut points
run real collectives of `torch.distributed`, each an autograd Function:

  column_input(x) — the "f" op at the input of a column-parallel layer:
      identity forward, all-reduce of the gradient over 'model' backward;
  replicated(x)   — the "g" op at the output of a row-parallel layer:
      all-reduce over 'model' forward (in fp32; `mesh.RowParallelDense`
      hands it fp32 partials and rounds once after the bias), identity
      backward;
  shard_hidden(x) — this rank's slice of a replicated activation along
      `dim` (forward), the slice's gradient zero-padded and all-reduced
      over 'model' (backward); x unchanged where the width does not divide;
  summed(x, group) — all-reduce forward and backward (BatchNorm's batch
      moments under data parallelism, as JAX's SPMD step computes them over
      the global batch: `train_dp.DataParallelBatchNorm`).

`tensor_parallel(mesh)` activates the first three for code run inside it;
outside it each is the identity, exactly as in JAX, so a single-device
forward runs as before. A context over an axis of size 1 activates nothing
(JAX's `tensor_parallel` keeps no context for a 1-wide axis either). The
models hold no parallel code: `mesh.shard_module_` puts the f op on each
column-parallel layer and swaps each row-parallel one. Every collective is
an `all_reduce` or a `broadcast`: the two that gloo carries for CUDA
tensors, so two ranks can share one card.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_STATE = threading.local()


def current_tp() -> Optional[Tuple["Mesh", str]]:  # noqa: F821 — parallel.mesh.Mesh
    return getattr(_STATE, "tp", None)


@contextlib.contextmanager
def tensor_parallel(mesh, axis: str = "model"):
    """Activate the TP collectives over ``mesh``'s `axis` group for code run
    inside."""
    prev = getattr(_STATE, "tp", None)
    _STATE.tp = (mesh, axis) if mesh.shape.get(axis, 1) > 1 else None
    try:
        yield
    finally:
        _STATE.tp = prev


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group` (nothing without a process group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceGrad(torch.autograd.Function):
    """f: identity forward, gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllReduceFwd(torch.autograd.Function):
    """g: summed over the group forward (in fp32), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = all_reduce_(x.float().contiguous().clone(), group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBoth(torch.autograd.Function):
    """Summed over the group forward, and its gradient summed backward:
    each rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Shard(torch.autograd.Function):
    """Slice `index` of `dim` into `size` pieces forward; the piece's
    gradient zero-padded to the whole and summed over the group backward."""

    @staticmethod
    def forward(ctx, x, dim, index, size, group):
        ctx.dim, ctx.index, ctx.size, ctx.group = dim, index, size, group
        ctx.shape = x.shape
        return x.chunk(size, dim=dim)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.chunk(ctx.size, dim=ctx.dim)[ctx.index].copy_(g)
        return all_reduce_(full, ctx.group), None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The value of rank `src` on every rank of the group forward; backward,
    the gradients of every rank summed into `src`'s input (the others get
    zeros: their input did not reach the output)."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        y = x.contiguous().clone()
        if group is not None:
            dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        if ctx.group is not None and dist.get_rank() != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None


def _tp_group():
    ctx = current_tp()
    if ctx is None:
        return None, None
    mesh, axis = ctx
    return mesh, mesh.group(axis)


def column_input(x: torch.Tensor) -> torch.Tensor:
    """The f op at a column-parallel layer's input (identity outside a
    tensor_parallel context)."""
    mesh, group = _tp_group()
    return x if mesh is None else _AllReduceGrad.apply(x, group)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """The g op at a row-parallel layer's output: the partial products of
    the model ranks summed (identity outside a tensor_parallel context)."""
    mesh, group = _tp_group()
    return x if mesh is None else _AllReduceFwd.apply(x, group)


def shard_hidden(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This model rank's slice of a replicated `x` along `dim`: no-op
    without an active context or when the axis does not divide."""
    ctx = current_tp()
    if ctx is None:
        return x
    mesh, axis = ctx
    size = mesh.shape[axis]
    d = dim % x.dim()
    if x.shape[d] % size != 0:
        return x
    return _Shard.apply(x, d, mesh.index(axis), size, mesh.group(axis))


def require_tp(module_name: str) -> None:
    """A layer that holds a tensor-parallel shard computes only its part:
    outside a tensor_parallel context its output would be wrong, so refuse."""
    if current_tp() is None:
        raise RuntimeError(f"{module_name} holds a tensor-parallel shard: run it inside "
                           "parallel.tensor_parallel(mesh)")


def summed(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, forward and backward."""
    return _AllReduceBoth.apply(x, group)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """`x` of global rank `src` on every rank of `group`, differentiable."""
    return _Broadcast.apply(x, src, group)
