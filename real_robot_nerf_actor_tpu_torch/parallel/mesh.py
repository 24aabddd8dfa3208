"""The ("data", "model") process mesh and the explicit Megatron placement
(the port's counterpart of the JAX package's `parallel/mesh.py`).

JAX builds a `jax.sharding.Mesh` of devices and lets XLA insert every
collective from NamedSharding constraints. Here the mesh is a grid of
`torch.distributed` ranks, rank = d * model + m as JAX lays its device
array out, with one process group per row and per column:

  data  — the batch axis (and the render loss's ray axis): the ranks that
          share a model index m;
  model — the tensor-parallel axis of the PerceiverIO heads and FF hidden
          and the ResnetFC hidden: the ranks that share a data index d.

`shard_params_rule` is the placement XLA derives from JAX's path rule, made
explicit: which leaves are column-parallel (output features cut, in fused
chunks where one Dense holds two outputs: to_kv's k|v and GEGLU's h|gates),
which are row-parallel (input features cut; the bias is added once, after
the all-reduce) and which stay replicated. `convert.shard_state_dict` and
`convert.gather_state_dict` slice and reassemble a state_dict by it, and
`shard_module_` cuts a live module by it: the models themselves hold no
parallel code.
"""
from __future__ import annotations

import dataclasses
import datetime
import socket
import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from real_robot_nerf_actor_tpu_torch.convert import (
    Placement, gather_state_dict, shard_state_dict)
from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, _dtype_for
from real_robot_nerf_actor_tpu_torch.parallel.constraints import (
    all_reduce_, column_input, replicated, require_tp)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1   # -1 = all remaining ranks
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        if self.data == -1:
            assert n_devices % self.model == 0
            return MeshSpec(data=n_devices // self.model, model=self.model)
        return self


class Mesh:
    """This rank's place in a (data, model) grid of ranks and the process
    groups of its row and column. Without a process group (one process, no
    `init_process_group`) the groups are None and every collective is a
    no-op; with one, every collective runs, also over a 1-wide axis."""

    def __init__(self, spec: MeshSpec, rank: int, groups: Mapping[str, object]):
        self.spec = spec
        self.rank = rank
        self._groups = dict(groups)
        self.shape = {"data": spec.data, "model": spec.model}

    def index(self, axis: str) -> int:
        return self.rank // self.spec.model if axis == "data" else self.rank % self.spec.model

    def group(self, axis: str):
        """The process group of this rank's `axis` ("data", "model" or
        "world"), or None without a process group."""
        return self._groups.get(axis)

    def rank_of(self, data: int, model: int) -> int:
        return data * self.spec.model + model

    def __repr__(self) -> str:
        return f"Mesh(data={self.spec.data}, model={self.spec.model}, rank={self.rank})"


def make_mesh(spec: MeshSpec = MeshSpec(), devices: Optional[Sequence] = None) -> Mesh:
    """The mesh over the ranks of the default process group (one rank
    without one). Every rank must call it, in the same order as its other
    group creations: it makes one group per data index and per model index.
    `devices` is taken for the JAX signature: the ranks are the devices."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    spec = spec.resolve(world)
    if spec.data * spec.model != world:
        raise ValueError(f"mesh {spec} needs {spec.data * spec.model} ranks, have {world}")
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(spec, 0, {})
    groups = {"world": dist.group.WORLD}
    for m in range(spec.model):
        g = dist.new_group([d * spec.model + m for d in range(spec.data)])
        if rank % spec.model == m:
            groups["data"] = g
    for d in range(spec.data):
        g = dist.new_group([d * spec.model + m for m in range(spec.model)])
        if rank // spec.model == d:
            groups["model"] = g
    return Mesh(spec, rank, groups)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of `x` (leading axis split over 'data')."""
    d, n = mesh.index("data"), mesh.shape["data"]
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split over {n} data ranks")
    b = x.shape[0] // n
    return x[d * b:(d + 1) * b]


def shard_rays(mesh: Mesh, rays: torch.Tensor) -> torch.Tensor:
    """This rank's rays of an (R, 8) ray batch: rays over 'data'."""
    return shard_batch(mesh, rays)


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` as rank 0 holds it, on every rank (in place). Kept for the JAX
    package's API: the port's step draws and initialises alike on every
    rank and does not call it."""
    if mesh.group("world") is not None:
        dist.broadcast(x, src=0, group=mesh.group("world"))
    return x


def data_parallel_shardings(mesh: Mesh, batch_example: Mapping[str, torch.Tensor],
                            params_example: Mapping[str, torch.Tensor]):
    """(batch placement, param placement) of a data-parallel step, as
    partition specs by name: every batch entry's leading axis over 'data',
    every parameter replicated (an empty spec). Kept for the JAX package's
    API: `train_dp.make_data_parallel_step` places by these rules itself."""
    batch = {k: ("data",) + (None,) * (v.dim() - 1) for k, v in batch_example.items()}
    return batch, {k: () for k in params_example}


def _cut_modules(module: torch.nn.Module, model_n: int):
    """(name, kind, module) of every tensor-parallel cut point in `module`
    whose width divides by model_n."""
    from real_robot_nerf_actor_tpu_torch.models.perceiver import GEGLUFeedForward, MHAttention
    from real_robot_nerf_actor_tpu_torch.models.resnetfc import QuantDense, ResnetBlockFC

    for name, m in module.named_modules():
        if isinstance(m, MHAttention) and m.heads % model_n == 0:
            yield name, "attention", m
        elif (isinstance(m, GEGLUFeedForward)
              and m.Dense_1.weight.shape[1] % model_n == 0):
            yield name, "ff", m
        elif (isinstance(m, ResnetBlockFC) and not hasattr(m, "Dense_2")
              and not isinstance(m.Dense_0, QuantDense)
              and m.Dense_0.weight.shape[0] % model_n == 0):
            yield name, "resnet_block", m


_PLAN = {
    "attention": {"to_q.weight": Placement("column"),
                  "to_kv.weight": Placement("column", chunks=2),    # k | v
                  "to_out.weight": Placement("row")},
    "ff": {"Dense_0.weight": Placement("column", chunks=2),         # h | gates
           "Dense_0.bias": Placement("column", chunks=2),
           "Dense_1.weight": Placement("row")},
    "resnet_block": {"Dense_0.weight": Placement("column"),
                     "Dense_0.bias": Placement("column"),
                     "Dense_1.weight": Placement("row")},
}


def shard_params_rule(mesh: Mesh, module: torch.nn.Module) -> Dict[str, Placement]:
    """The tensor-parallel placement of `module`'s parameters over 'model',
    by parameter name: the Megatron cut of every MHAttention whose heads
    divide by the model axis (to_q / to_kv column-parallel by heads, to_out
    row-parallel), every GEGLU FF (Dense_0 column, Dense_1 row) and every
    ResnetFC block (Dense_0 column, Dense_1 row) whose hidden width divides.
    A parameter not named is replicated (every row-parallel bias among
    them); so is everything with a model axis of 1."""
    model_n = mesh.shape["model"]
    if model_n <= 1:
        return {}
    out = {}
    for name, kind, _ in _cut_modules(module, model_n):
        prefix = f"{name}." if name else ""
        out.update({prefix + leaf: p for leaf, p in _PLAN[kind].items()})
    return out


class RowParallelDense(Dense):
    """A Dense cut along its input features (`shard_module_` swaps it in):
    this model rank's partial product of the operands in the layer's dtype,
    kept in fp32, summed over the model axis (`constraints.replicated`),
    then the bias, once, and one rounding to the layer's dtype, as the one
    GEMM of the whole layer rounds once."""

    def forward(self, x):
        require_tp("a row-parallel Dense")
        dt = _dtype_for(x, self.weight, self.dtype)
        y = replicated(F.linear(x.to(dt).float(), self.weight.to(dt).float()))
        if self.bias is not None:
            y = y + self.bias.to(dt).float()
        return y.to(dt)


def _column_input(layer, args):
    """Forward pre-hook of a column-parallel Dense: the f op on its input."""
    require_tp("a column-parallel Dense")
    return (column_input(args[0]),) + tuple(args[1:])


def shard_module_(mesh: Mesh, module: torch.nn.Module,
                  placements: Mapping[str, Placement]) -> torch.nn.Module:
    """Cut `module` in place to this model rank's part of `placements`: its
    parameters to their shards (`convert.shard_state_dict`), every
    column-parallel Dense given the f op on its input (a forward pre-hook),
    every row-parallel Dense made a RowParallelDense. The cut layers compute
    their part inside `tensor_parallel(mesh)` and raise outside it."""
    if not placements:
        return module
    params = dict(module.named_parameters())
    shards = shard_state_dict({n: params[n].data for n in placements}, placements,
                              mesh.index("model"), mesh.shape["model"])
    for name, t in shards.items():
        params[name].data = t
    for name, pl in placements.items():
        if name.endswith(".weight"):
            layer = module.get_submodule(name[:-len(".weight")])
            if pl.kind == "column":
                layer.register_forward_pre_hook(_column_input)
            else:
                layer.__class__ = RowParallelDense
    return module


def gather_tensors(mesh: Mesh, named: Mapping[str, torch.Tensor],
                   placements: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """The whole tensors of this rank's shards, on every rank: each sharded
    entry put into zeros of the whole shape (`convert.gather_state_dict`
    with the other ranks' shards zero) and summed over 'model' (an
    all-reduce); the rest are returned as they are."""
    rank, size = mesh.index("model"), mesh.shape["model"]
    own = {n: t for n, t in named.items() if n in placements}
    zeros = {n: torch.zeros_like(t) for n, t in own.items()}
    placed = gather_state_dict([own if r == rank else zeros for r in range(size)], placements)
    return {n: all_reduce_(placed[n], mesh.group("model")) if n in own else t
            for n, t in named.items()}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world_size: int, port: int, backend: str = "gloo",
              timeout_s: float = 300.0) -> None:
    """`init_process_group` at tcp://localhost:port (nothing tells a program
    of a cluster here: address, size and rank are given)."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def run_ranks(fn: Callable, world_size: int, args: tuple = (), timeout_s: float = 600.0
              ) -> None:
    """Run fn(rank, world_size, port, *args) in `world_size` spawned
    processes and wait at most timeout_s for all of them; a rank that fails
    or a run past the deadline ends every process and raises."""
    import torch.multiprocessing as mp

    port = free_port()
    ctx = mp.start_processes(fn, args=(world_size, port) + tuple(args), nprocs=world_size,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)

