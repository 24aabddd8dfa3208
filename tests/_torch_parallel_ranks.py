"""Rank bodies of tests/test_torch_parallel.py, spawned by
`parallel.mesh.run_ranks` (gloo on the CPU). They import no JAX: each
reads its inputs from a torch.save file the test wrote and leaves its
results in out_dir. `planted` puts in one of the faults the checks must see."""
import contextlib
import os

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def planted(fault):
    """k|v cut contiguously, a row-parallel bias added on every rank,
    BatchNorm statistics left local, or the clip's norm over local shards."""
    from real_robot_nerf_actor_tpu_torch.convert import Placement
    from real_robot_nerf_actor_tpu_torch.models import blocks
    from real_robot_nerf_actor_tpu_torch.parallel import mesh as pmesh
    from real_robot_nerf_actor_tpu_torch.parallel import train_dp
    from real_robot_nerf_actor_tpu_torch.parallel.constraints import replicated

    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "kv_contiguous":
        patch_plan = dict(pmesh._PLAN["attention"], **{"to_kv.weight": Placement("column")})
        patch(pmesh, "_PLAN", dict(pmesh._PLAN, attention=patch_plan))
    elif fault == "bias_every_rank":
        def bias_every_rank(dense, x):
            dt = blocks._dtype_for(x, dense.weight, dense.dtype)
            b = None if dense.bias is None else dense.bias.to(dt)
            return replicated(F.linear(x.to(dt), dense.weight.to(dt), b))
        patch(pmesh.RowParallelDense, "forward", bias_every_rank)
    elif fault == "bn_local":
        patch(train_dp.DataParallelBatchNorm, "batch_moments", blocks.BatchNorm.batch_moments)
    elif fault == "clip_local":
        patch(train_dp.GradSync, "global_norm",
              lambda self, norms: torch.linalg.vector_norm(norms))
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def _setup(rank, world, port, spec):
    from real_robot_nerf_actor_tpu_torch.parallel.mesh import init_rank, make_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, port, "gloo", timeout_s=120)
    return make_mesh(spec)


def _tp_forward(mesh, inp, fault):
    """PerceiverIO forward and backward of sum(w_i * out_i) on TP shards:
    (outputs, whole gradients)."""
    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    from real_robot_nerf_actor_tpu_torch.parallel import (
        shard_module_, shard_params_rule, tensor_parallel)
    from real_robot_nerf_actor_tpu_torch.parallel.mesh import gather_tensors

    with planted(fault):
        net = PerceiverIO(inp["cfg"])
        net.load_state_dict(inp["sd"])
        placements = shard_params_rule(mesh, net)
        shard_module_(mesh, net, placements)
        with tensor_parallel(mesh):
            out = net(*inp["args"])
            loss = sum((o.float() * w).sum() for o, w in zip(out, inp["w"]))
            loss.backward()
    grads = gather_tensors(mesh, {n: p.grad for n, p in net.named_parameters()}, placements)
    return [o.detach() for o in out], grads, placements


def tp_worker(rank, world, port, in_path, out_dir):
    """model = 2: the mesh's axes, the PerceiverIO and ResnetFC forwards
    (each fault), the clip's global norm, the joint step and a whole
    checkpoint of its sharded state."""
    import torch.distributed as dist

    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    from real_robot_nerf_actor_tpu_torch.models.resnetfc import ResnetFC
    from real_robot_nerf_actor_tpu_torch.parallel import (
        MeshSpec, make_mesh, shard_hidden, shard_module_, shard_params_rule, tensor_parallel)
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import (
        GradSync, make_data_parallel_step, save_checkpoint, whole_grads)
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.trainer import (
        CheckpointManager, OptimConfig, Optimizer)

    mesh = _setup(rank, world, port, MeshSpec(data=1, model=2))
    inp = torch.load(in_path, weights_only=False)
    res = {"mesh": dict(mesh.shape), "index": (mesh.index("data"), mesh.index("model")),
           "resolved": dict(make_mesh(MeshSpec()).shape)}
    # shard_hidden: this rank's half forward, the whole gradient backward
    x = torch.arange(8.0, requires_grad=True)
    with tensor_parallel(mesh):
        y = shard_hidden(x)
        odd = shard_hidden(torch.arange(7.0))
    (y * (mesh.index("model") + 1.0)).sum().backward()
    res["shard_hidden"] = (y.detach(), x.grad, odd)
    for fault in (None, "kv_contiguous", "bias_every_rank"):
        out, grads, placements = _tp_forward(mesh, inp["perceiver"], fault)
        res[f"perceiver/{fault}"] = dict(out=out, grads=grads, placements=placements)
        r = inp["resnetfc"]
        with planted(fault):
            net = ResnetFC(**r["kw"])
            net.load_state_dict(r["sd"])
            shard_module_(mesh, net, shard_params_rule(mesh, net))
            with tensor_parallel(mesh), torch.no_grad():
                res[f"resnetfc/{fault}"] = net(r["x"])[0]
    # the clip's global norm over the sharded PerceiverIO gradients
    net = PerceiverIO(inp["perceiver"]["cfg"])
    net.load_state_dict(inp["perceiver"]["sd"])
    shard_module_(mesh, net, placements)
    with tensor_parallel(mesh):
        out = net(*inp["perceiver"]["args"])
        sum((o.float() * w).sum() for o, w in zip(out, inp["perceiver"]["w"])).backward()
    opt = Optimizer(OptimConfig(grad_clip=1e-3), net.named_parameters())
    opt.sync = GradSync(mesh, opt.names, placements)
    norms = torch.stack(torch._foreach_norm([q.grad for q in opt.params], 2))
    for fault in (None, "clip_local"):
        with planted(fault):
            res[f"clip_norm/{fault}"] = opt.sync.global_norm(norms).item()
    # the joint step on tensor-parallel shards, and its whole checkpoint
    j = inp["joint"]
    tr = NerfActTrainer(j["cfg"], device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(j["sd"])
    step, place_state, place_batch = make_data_parallel_step(
        tr.train_step, mesh, state, j["batch"], tensor_parallel=True)
    state = place_state(state)
    state, m = step(state, place_batch(j["batch"]), None, **j["draws"])
    res["joint"] = dict(metrics={k: v.item() for k, v in m.items()},
                        grads={k: v.clone() for k, v in
                               whole_grads(mesh, state.module, step.placements).items()},
                        buffers={k: v.clone() for k, v in state.module.named_buffers()},
                        n_sharded=len(step.placements))
    save_checkpoint(CheckpointManager(os.path.join(out_dir, "ckpt")), 1, state, mesh,
                    step.placements)
    # the live optimizer keeps its shards: the run steps on after the save
    state, m2 = step(state, place_batch(j["batch"]), None, **j["draws"])
    res["joint_after_save"] = m2["loss_total"].item()
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "tp.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dp_worker(rank, world, port, in_path, out_dir):
    """data = 2: rays split over the ranks, the PerAct step with a UNet
    encoder (and with BatchNorm statistics left local), the joint step."""
    import torch.distributed as dist

    from real_robot_nerf_actor_tpu_torch.parallel import MeshSpec, shard_rays
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import make_data_parallel_step
    from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActTrainer

    mesh = _setup(rank, world, port, MeshSpec(data=2, model=1))
    inp = torch.load(in_path, weights_only=False)
    res = {}
    r = inp["render"]
    rend = NeuralRenderer(r["cfg"], device="cpu")
    rend.load_field(r["sd"])
    with torch.no_grad():
        o = rend.render_rays(r["vox"], shard_rays(mesh, r["rays"]),
                             draws={k: shard_rays(mesh, v) for k, v in r["draws"].items()})
    res["render"] = o["fine"].rgb
    p = inp["peract"]
    for fault in (None, "bn_local"):
        with planted(fault):
            tr = PerActTrainer(p["cfg"], device="cpu")
            state = tr.init_state(torch.Generator().manual_seed(0))
            state.module.load_state_dict(p["sd"])
            step, place_state, place_batch = make_data_parallel_step(
                tr.train_step, mesh, state, p["batch"])
            state = place_state(state)
            state, m = step(state, place_batch(p["batch"]), None, draws=p["draws"])
        named = dict(state.module.named_parameters())
        res[f"peract/{fault}"] = dict(metrics={k: v.item() for k, v in m.items()},
                                      params={n: q.detach() for n, q in named.items()},
                                      grads={n: q.grad for n, q in named.items()},
                                      buffers=dict(state.module.named_buffers()))
    j = inp["joint"]
    tr = NerfActTrainer(j["cfg"], device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(j["sd"])
    step, place_state, place_batch = make_data_parallel_step(tr.train_step, mesh, state,
                                                             j["batch"])
    state = place_state(state)
    state, m = step(state, place_batch(j["batch"]), None, **j["draws"])
    res["joint"] = dict(metrics={k: v.item() for k, v in m.items()},
                        grads={n: q.grad for n, q in state.module.named_parameters()},
                        buffers=dict(state.module.named_buffers()))
    torch.save(res, os.path.join(out_dir, f"dp{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
