"""The port's multi-device gate: one NeRF-Actor joint training step with
dp (batch) + sp (rays) + tp (heads and hidden) over spawned ranks (the
counterpart of `__graft_entry__.dryrun_multichip`).

    python -m real_robot_nerf_actor_tpu_torch.parallel.dryrun --n 4 \
        [--scale tiny|flagship] [--model-axis 2] [--timed-steps 0] \
        [--device cuda|cpu] [--backend gloo]

It runs on the card unless asked for the CPU (`--device cpu`; without CUDA
the card raises). It spawns its n ranks itself (torch.multiprocessing,
tcp://localhost on a free port; gloo, which carries every rank's tensors on
the one card 0 or on the CPU), lays them out as JAX lays its devices (model
axis 2 where n is even, else 1; GRAFT_MULTICHIP_MODEL_AXIS overrides, as
the JAX gate reads it), builds the tiny or flagship config of the JAX gate,
shards the state (`make_data_parallel_step(..., tensor_parallel=True)`),
takes one step on the global batch and the global draws, and checks the
loss against the same step on one rank: rel < 1e-3. The environment
variables GRAFT_MULTICHIP_SCALE, _TIMED_STEPS and _ARTIFACT are read as the
JAX gate reads them. Prints `dryrun_multichip OK [scale]: {...}`.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)


def gate_config(scale: str):
    """The JAX gate's NerfActConfig (`__graft_entry__.py:139-178`)."""
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.render import RendererConfig
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig

    train = TrainConfig(num_steps=1, optim=OptimConfig(lr=1e-3))
    if scale == "flagship":
        model = PerceiverConfig(depth=6, voxel_size=100, num_latents=2048, latent_dim=512,
                                input_encoder="unet", return_voxel_feat=True)
        vox = VoxelizerSpec(voxel_size=100, feature_size=3, max_num_coords=8192)
        rend = RendererConfig(image_width=80, image_height=60, n_coarse=64, n_fine=32,
                              n_fine_depth=16, ray_chunk_size=512,
                              field=NerfFieldConfig(d_latent=64, d_embed=512, d_hidden=512,
                                                    n_blocks=5, combine_layer=3,
                                                    coord_bounds=BOUNDS))
    elif scale == "tiny":
        model = PerceiverConfig(depth=1, voxel_size=10, num_latents=16, latent_dim=32,
                                im_channels=8, cross_dim_head=8, latent_dim_head=8,
                                latent_heads=2, voxel_patch_size=5, final_dim=8,
                                lang_emb_dim=16, lang_max_seq_len=4, num_rotation_classes=72,
                                input_encoder="unet", return_voxel_feat=True)
        vox = VoxelizerSpec(voxel_size=10, feature_size=3, max_num_coords=512)
        rend = RendererConfig(image_width=8, image_height=8, n_coarse=6, n_fine=4,
                              n_fine_depth=2, ray_chunk_size=8,
                              field=NerfFieldConfig(d_latent=8, d_embed=4, d_hidden=16,
                                                    n_blocks=2, combine_layer=1,
                                                    coord_bounds=BOUNDS))
    else:
        raise ValueError(f"unknown scale {scale!r}")
    return NerfActConfig(peract=PerActConfig(model=model, voxelizer=vox, coord_bounds=BOUNDS,
                                             train=train),
                         renderer=rend)


def model_axis_for(n_devices: int) -> int:
    """2 where n is even and above 1, else 1; GRAFT_MULTICHIP_MODEL_AXIS
    overrides where it divides n (as the JAX gate chooses)."""
    axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    env = os.environ.get("GRAFT_MULTICHIP_MODEL_AXIS")
    if env:
        try:
            parsed = int(env)
        except ValueError:
            raise ValueError(f"GRAFT_MULTICHIP_MODEL_AXIS={env!r} is not an integer")
        if parsed <= 0:
            raise ValueError(f"GRAFT_MULTICHIP_MODEL_AXIS={env} must be >= 1")
        if n_devices % parsed == 0:
            axis = parsed
    return axis


def global_batch(tr, batch_size: int):
    """The gate's batch: synthetic, clouds cut to max_num_coords."""
    ncap = tr.cfg.voxelizer.max_num_coords
    return {k: v[:, :ncap] if k in ("points", "colors", "valid") else v
            for k, v in next(tr.synthetic_data(batch_size=batch_size)).items()}


def _rank(rank: int, world: int, port: int, scale: str, model_axis: int, timed: int,
          out_path: str, device: str, backend: str) -> None:
    import torch
    import torch.distributed as dist

    from real_robot_nerf_actor_tpu_torch.parallel.mesh import MeshSpec, init_rank, make_mesh
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import (
        global_draws, make_data_parallel_step)
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer

    if device == "cpu":
        torch.set_num_threads(1)
    init_rank(rank, world, port, backend)
    mesh = make_mesh(MeshSpec(data=world // model_axis, model=model_axis))
    tr = NerfActTrainer(gate_config(scale), device=device)
    batch = global_batch(tr, mesh.shape["data"])
    state = tr.init_state(torch.Generator().manual_seed(0))
    whole = {k: v.clone() for k, v in state.module.state_dict().items()}
    step, place_state, place_batch = make_data_parallel_step(
        tr.train_step, mesh, state, batch, tensor_parallel=True)
    state = place_state(state)
    draws = global_draws(tr, mesh.shape["data"], torch.Generator().manual_seed(1))
    local = place_batch(batch)
    state, metrics = step(state, local, None, **draws)
    out = {"loss_total": metrics["loss_total"].item()}
    if timed > 0:
        # steps/s on this mesh: ranks that share a host's cores measure work
        # conservation, not speed-up
        gen = torch.Generator().manual_seed(2)
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _m = step(state, local, gen)
        if device != "cpu":
            torch.cuda.synchronize()
        out["steps_per_sec"] = timed / (time.perf_counter() - t0)
        out["global_batch"] = int(mesh.shape["data"])
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        ref = tr.init_state(torch.Generator().manual_seed(0))
        ref.module.load_state_dict(whole)
        _, m1 = tr.train_step(ref, batch, None, **draws)
        single = m1["loss_total"].item()
        out["loss_single_device"] = single
        out["rel_err"] = abs(out["loss_total"] - single) / max(abs(single), 1e-9)
        out["mesh"] = dict(mesh.shape)
        with open(out_path, "w") as f:
            json.dump(out, f)


def dryrun_multichip(n_devices: int, scale: Optional[str] = None,
                     model_axis: Optional[int] = None, timed_steps: Optional[int] = None,
                     device: str = "cuda", backend: str = "gloo",
                     timeout_s: float = 1800.0) -> dict:
    """Run the gate over n_devices spawned ranks on `device` (every rank on
    card 0, or on the CPU with device="cpu"); returns the printed dict.
    Raises when CUDA is asked for and missing, a rank fails, the run
    outlasts timeout_s, or the sharded loss is 1e-3 or more from the
    one-rank step's."""
    from real_robot_nerf_actor_tpu_torch.parallel.mesh import run_ranks
    from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device

    device = str(resolve_device(device))

    scale = scale or os.environ.get("GRAFT_MULTICHIP_SCALE", "tiny")
    model_axis = model_axis or model_axis_for(n_devices)
    timed = (timed_steps if timed_steps is not None
             else int(os.environ.get("GRAFT_MULTICHIP_TIMED_STEPS", "0")))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank, n_devices, (scale, model_axis, timed, path, device, backend),
                  timeout_s=timeout_s)
        with open(path) as f:
            out = json.load(f)
    if not out["rel_err"] < 1e-3:
        raise AssertionError(f"sharded/single-device divergence: {out['loss_total']} vs "
                             f"{out['loss_single_device']} (rel {out['rel_err']:.2e})")
    out["n_devices"] = int(n_devices)
    out["scale"] = scale
    art = os.environ.get("GRAFT_MULTICHIP_ARTIFACT")
    if art:
        with open(art, "a" if os.path.exists(art) else "w") as f:
            f.write(json.dumps(out) + "\n")
    print(f"dryrun_multichip OK [{scale}]:", out, flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4, help="ranks (devices of the mesh)")
    ap.add_argument("--scale", default=None, choices=["tiny", "flagship"])
    ap.add_argument("--model-axis", type=int, default=None)
    ap.add_argument("--timed-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device: cuda (every rank on card 0 over gloo), or cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n, args.scale, args.model_axis, args.timed_steps,
                            args.device, args.backend, args.timeout)


if __name__ == "__main__":
    main()
