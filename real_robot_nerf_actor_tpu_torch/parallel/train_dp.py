"""Data-, ray- and tensor-parallel training: wrap a trainer's step for a
mesh (the port's counterpart of the JAX package's `parallel/train_dp.py`).

`make_data_parallel_step(tr.train_step, mesh, state, batch,
tensor_parallel=...)` returns (step, place_state, place_batch), as in JAX:

  place_state — with tensor_parallel, cuts the module to this model rank's
      shards (`mesh.shard_params_rule`, the explicit Megatron placement)
      and rebuilds its optimizer over them; with more than one data rank,
      makes every BatchNorm a DataParallelBatchNorm (a training batch
      normalised by the global batch's moments, as JAX's SPMD step
      computes them); installs the optimizer's `sync`:
      gradients all-reduced as a mean over 'data', the non-finite flag over
      every rank, the clip's global norm summing the squares of sharded
      leaves over 'model' and counting each replicated leaf once;
  place_batch — this rank's rows of a global batch (leading axis over
      'data');
  step(state, batch, generator) — one step of the wrapped trainer on this
      rank's rows. Every rank draws the global batch's draws from the one
      generator (SE(3) shifts; for the joint step the rendering loss's rays
      and their sampler draws) in the order the bare step draws them, and
      takes its slice: the result does not depend on the world size, and a
      rank never seeds a generator of its own. With tensor_parallel the TP
      collectives are active (`constraints.tensor_parallel`). The joint
      step's rendering loss (sample 0's view) is ray-parallel: sample 0's d0
      and view are broadcast from the first data rank of this rank's column
      (the gradient of d0 summed back into it), and each data rank renders
      its slice of the rays; the model ranks of a data group render the
      same rays on the tensor-parallel field. The metrics come back as their
      mean over 'data' (psnr from that mean's fine rgb MSE).

Every collective is an all_reduce or a broadcast, the two that gloo carries
for CUDA tensors, so ranks may share one card over gloo; NCCL needs a card
a rank. A checkpoint is written whole (`save_checkpoint`), so a
tensor-parallel run's checkpoint loads at world size 1.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from real_robot_nerf_actor_tpu_torch.convert import Placement
from real_robot_nerf_actor_tpu_torch.models.blocks import BatchNorm
from real_robot_nerf_actor_tpu_torch.parallel import constraints
from real_robot_nerf_actor_tpu_torch.parallel.constraints import (
    all_reduce_, broadcast_from, summed)
from real_robot_nerf_actor_tpu_torch.parallel.mesh import (
    Mesh, gather_tensors, shard_batch, shard_module_, shard_params_rule)
from real_robot_nerf_actor_tpu_torch.train.trainer import (
    CheckpointManager, Optimizer, TrainState)

__all__ = ["DataParallelBatchNorm", "GradSync", "RaySplit", "global_draws",
           "make_data_parallel_step", "save_checkpoint", "shard_params_rule", "whole_grads"]


class DataParallelBatchNorm(BatchNorm):
    """BatchNorm whose training batch is the global one: the sums, squared
    sums and counts all-reduced over the 'data' group (`group`), the
    gradient through the all-reduce; then flax's fast variance, as the
    single-device step computes it over the whole batch."""

    group = None

    def batch_moments(self, xf, dims):
        n = torch.full_like(xf[(0,) * len(dims)], xf.numel() // xf.shape[-1])
        s1, s2, n = (summed(t, self.group)
                     for t in (xf.sum(dim=dims), (xf * xf).sum(dim=dims), n))
        mean = s1 / n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)


class GradSync:
    """The optimizer's collectives for one mesh (see Optimizer.sync)."""

    def __init__(self, mesh: Mesh, names: List[str], placements: Mapping[str, Placement]):
        self.mesh = mesh
        self.sharded = [n in placements for n in names]

    def reduce_grads(self, params, grads):
        """Each gradient's mean over 'data' (one all-reduce per dtype), put
        into the parameters' `.grad` and returned."""
        group, n = self.mesh.group("data"), self.mesh.shape["data"]
        if group is None:
            return grads
        out = list(grads)
        for dtype in {g.dtype for g in grads}:
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = _flatten_dense_tensors([grads[i] for i in idx])
            all_reduce_(flat, group)
            if n > 1:
                flat.div_(n)
            for i, t in zip(idx, _unflatten_dense_tensors(flat, [grads[i] for i in idx])):
                out[i] = t
        for p, g in zip(params, out):
            p.grad = g
        return out

    def all_finite(self, finite: bool) -> bool:
        group = self.mesh.group("world")
        if group is None:
            return finite
        dev = "cpu" if torch.distributed.get_backend(group) == "gloo" else "cuda"
        flag = torch.tensor([0.0 if finite else 1.0], device=dev)
        return all_reduce_(flag, group).item() == 0.0

    def global_norm(self, norms: torch.Tensor) -> torch.Tensor:
        """sqrt(sum over model ranks of the sharded leaves' squares + the
        replicated leaves' squares, once)."""
        if not any(self.sharded) or self.mesh.group("model") is None:
            return torch.linalg.vector_norm(norms)
        mask = torch.tensor(self.sharded, device=norms.device)
        sq = norms.float() ** 2
        sharded = all_reduce_(sq[mask].sum(), self.mesh.group("model"))
        return torch.sqrt(sharded + sq[~mask].sum())


class RaySplit:
    """The joint step's ray-parallel render (NerfActTrainer.ray_split):
    sample 0's d0 and view from the column's first data rank, this data
    rank's slice of the rays and their draws, and the depth terms'
    denominator over every rank's rays (scaled to the mean over 'data' the
    gradient sync takes)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, view, ray_idx, render_draws):
        mesh = self.mesh
        n, d, group = mesh.shape["data"], mesh.index("data"), mesh.group("data")
        if ray_idx is None or render_draws is None:
            raise ValueError("a ray-parallel render takes the global ray_idx and draws")
        if ray_idx.shape[0] % n:
            raise ValueError(f"{ray_idx.shape[0]} rays do not split over {n} data ranks")
        src = mesh.rank_of(0, mesh.index("model"))
        view = [None if t is None else broadcast_from(t, src, group) for t in view]
        r = ray_idx.shape[0] // n
        sl = slice(d * r, (d + 1) * r)

        def denominator(count):
            return torch.clamp(all_reduce_(count.detach().clone(), group), min=1.0) / n

        return view, ray_idx[sl], {k: v[sl] for k, v in render_draws.items()}, denominator


def render_draws(rc, share_mlp: bool, n_rays: int, generator, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """render_rays' draws for a training render of n_rays rays (stratified:
    rendering_loss passes no occupancy), drawn from `generator` in the
    order render_rays draws them."""
    dev = generator.device if generator is not None else "cpu"

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=dtype)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype)

    out = {"coarse_u": rand(n_rays, rc.n_coarse)}
    if rc.noise_std > 0:
        out["noise_coarse"] = randn(n_rays, rc.n_coarse)
    if not rc.using_fine:
        return out
    nf = rc.n_fine - rc.n_fine_depth
    if nf > 0:
        out["fine_u"] = rand(n_rays, nf)
        out["fine_jitter"] = rand(n_rays, nf)
    if rc.n_fine_depth > 0:
        out["fine_depth_eps"] = randn(n_rays, rc.n_fine_depth)
    if rc.noise_std > 0:
        k = (rc.n_fine if rc.field.use_proposal or (rc.reuse_coarse and share_mlp)
             else rc.n_coarse + rc.n_fine)
        out["noise_fine"] = randn(n_rays, k)
    return out


def global_draws(tr, batch_size: int, generator) -> Dict[str, object]:
    """Every draw of one step of `tr` on a global batch of batch_size, in
    the order the bare train_step draws them from `generator`: the SE(3)
    shifts' uniforms (B, 3); for the joint step ray_idx and the render
    draws."""
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer

    dev = generator.device if generator is not None else "cpu"
    out: Dict[str, object] = {}
    if tr.cfg.use_se3_aug:
        out["draws"] = torch.rand((batch_size, 3), generator=generator, device=dev) * 2.0 - 1.0
    if isinstance(tr, NerfActTrainer):
        rc = tr.jcfg.renderer
        r = rc.ray_chunk_size
        out["ray_idx"] = torch.randint(0, rc.image_height * rc.image_width, (r,),
                                       generator=generator, device=dev)
        out["render_draws"] = render_draws(rc, tr.renderer.field.share_mlp, r, generator)
    return out


def _mean_metrics(mesh: Mesh, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    group, n = mesh.group("data"), mesh.shape["data"]
    if group is None or n == 1:
        return metrics
    keys = sorted(metrics)
    vals = all_reduce_(torch.stack([metrics[k].float() for k in keys]), group) / n
    out = dict(zip(keys, vals.unbind()))
    if "psnr" in out and "loss_rgb_fine" in out:
        out["psnr"] = 20.0 * torch.log10(1.0 / torch.sqrt(out["loss_rgb_fine"] + 1e-20))
    return out


def make_data_parallel_step(train_step: Callable, mesh: Mesh, state_example: TrainState,
                            batch_example: Optional[Mapping[str, torch.Tensor]] = None,
                            tensor_parallel: bool = False):
    """(step, place_state, place_batch) for `train_step`, a PerActTrainer's
    or NerfActTrainer's bound train_step (see the module docstring).
    step(state, batch, generator, draws=None, ray_idx=None,
    render_draws=None) takes this rank's rows of the batch; draws, ray_idx
    and render_draws are the global batch's (each drawn from `generator`
    where absent). batch_example is taken for the JAX signature."""
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer

    tr = train_step.__self__
    joint = isinstance(tr, NerfActTrainer)
    placements = shard_params_rule(mesh, state_example.module) if tensor_parallel else {}
    if placements and joint and tr.jcfg.renderer.field.mlp_backend != "xla":
        raise ValueError("a tensor-parallel field trains on mlp_backend 'xla': the serving "
                         "kernels pack the whole field")
    n = mesh.shape["data"]

    def place_state(state: TrainState) -> TrainState:
        if placements:
            opt = state.optimizer
            if opt.count or opt.mini_step or opt.adamw.state:
                raise ValueError("place a fresh state: the optimizer has stepped and its "
                                 "moments are whole")
            shard_module_(mesh, state.module, placements)
            state.optimizer = Optimizer(opt.cfg, state.module.named_parameters())
        if n > 1:
            for m in state.module.modules():
                if type(m) is BatchNorm:
                    m.__class__ = DataParallelBatchNorm
                    m.group = mesh.group("data")
        state.optimizer.sync = GradSync(mesh, state.optimizer.names, placements)
        return state

    def place_batch(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: shard_batch(mesh, v) for k, v in batch.items()}

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], generator=None,
             draws=None, ray_idx=None, render_draws=None):
        b = next(iter(batch.values())).shape[0]
        given = {"draws": draws, "ray_idx": ray_idx, "render_draws": render_draws}
        needed = (["draws"] if tr.cfg.use_se3_aug else []) + (
            ["ray_idx", "render_draws"] if joint else [])
        if any(given[k] is None for k in needed):
            drawn = global_draws(tr, b * n, generator)
            given = {k: drawn[k] if given[k] is None and k in needed else given[k]
                     for k in given}
        kw = {}
        if given["draws"] is not None:
            kw["draws"] = shard_batch(mesh, given["draws"])
        if joint:
            kw.update(ray_idx=given["ray_idx"], render_draws=given["render_draws"])
            prev, tr.ray_split = tr.ray_split, (RaySplit(mesh) if n > 1 else None)
        tp = (constraints.tensor_parallel(mesh) if tensor_parallel
              else contextlib.nullcontext())
        try:
            with tp:
                state, metrics = train_step(state, batch, generator, **kw)
        finally:
            if joint:
                tr.ray_split = prev
        return state, _mean_metrics(mesh, metrics)

    step.placements = placements
    return step, place_state, place_batch


def whole_grads(mesh: Mesh, module: torch.nn.Module,
                placements: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """Every parameter's `.grad`, whole, by name (zeros where None)."""
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in module.named_parameters()}
    return gather_tensors(mesh, grads, placements)


def _whole_optimizer_state(mesh: Mesh, opt: Optimizer,
                           placements: Mapping[str, Placement]) -> dict:
    """opt.state_dict() with every moment (and accumulator) whole; the live
    optimizer keeps its shards."""
    sd = opt.state_dict()
    moments = {}
    for i, name in enumerate(opt.names):
        st = sd["adamw"]["state"].get(i)
        if st is not None:
            moments[i] = {k: gather_tensors(mesh, {name: v}, placements)[name]
                          if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
    sd["adamw"] = dict(sd["adamw"], state=moments)
    if sd["acc"] is not None:
        sd["acc"] = [gather_tensors(mesh, {n: a}, placements)[n]
                     for n, a in zip(opt.names, sd["acc"])]
    return sd


def save_checkpoint(mgr: CheckpointManager, step: int, state: TrainState, mesh: Mesh,
                    placements: Mapping[str, Placement]) -> None:
    """Write the checkpoint of a (tensor-)parallel run whole: every rank
    takes part in the gathers, global rank 0 writes the file that a run at
    any world size restores."""
    params = gather_tensors(mesh, state.module.state_dict(), placements)
    opt_sd = _whole_optimizer_state(mesh, state.optimizer, placements)
    if mesh.rank == 0:
        mgr.save(step, state, params=params, opt_state=opt_sd)
    if mesh.group("world") is not None:
        torch.distributed.barrier(group=mesh.group("world"))
