"""Device and wall time of the PerAct train step, and the `final` conv's
VJP against another commit's, on a CUDA card.

    python -m real_robot_nerf_actor_tpu_torch.tools.train_step
    python -m real_robot_nerf_actor_tpu_torch.tools.train_step --against DIR

The step of configs/peract.yaml (PerActConfig's defaults in bf16: conv1
encoder, depth 6, 100^3 x 10 voxels, 2048 x 512 latents, 220000 points,
batch 1), weights from a seed, one fixed synthetic batch and fixed SE(3)
draws, for conv_backend "conv2d" and "pallas" (the k3 kernel and its VJP).
After 3 untimed steps of each, each of 10 rounds steps every variant once
under torch.profiler (device_ms: the kernels of the step, record_function
spans left out) and once without it (wall_ms: host clock to a
synchronise), the variants in turns, the order reversed every other
round. One JSON line per variant: median and quartiles of both, and the
rounds it was faster on device time than "conv2d".

With --against DIR, a directory holding another commit's
`real_robot_nerf_actor_tpu_torch/` (unpacked with `git archive`, e.g. the
parent's), that package's `conv3d_k3_vjp` joins as a third variant,
"pallas_against", and the two VJPs are also timed alone at the `final`
conv's shape (1, 100^3, 128 -> 64, bf16) in turns (median of CUDA events
over 10 calls a round). Each line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from real_robot_nerf_actor_tpu_torch.convert import final_conv_as_plain
from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops import _build, conv3d_cuda
from real_robot_nerf_actor_tpu_torch.tools.launch_cost import card, event_ms
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer

ROUNDS = 10


def device_ms(fn) -> float:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    cpu = torch.autograd.DeviceType.CPU
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != cpu and e.key not in spans) / 1e3


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def quartiles(xs):
    s = sorted(xs)
    return {"median": statistics.median(s), "q1": s[len(s) // 4], "q3": s[3 * len(s) // 4]}


def load_vjp(root: Path):
    path = root / "real_robot_nerf_actor_tpu_torch" / "ops" / "conv3d_cuda.py"
    spec = importlib.util.spec_from_file_location("against_conv3d_cuda", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.conv3d_k3_vjp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    name = card()
    dev = torch.device("cuda")
    own_vjp = conv3d_cuda.conv3d_k3_vjp
    vjps = {"pallas": own_vjp}
    if args.against is not None:
        vjps["pallas_against"] = load_vjp(args.against)

    def cfg(conv):
        return PerActConfig(model=PerceiverConfig(compute_dtype="bfloat16", conv_backend=conv))

    trainers = {"conv2d": PerActTrainer(cfg("conv2d"), device=dev),
                "pallas": PerActTrainer(cfg("pallas"), device=dev)}
    states = {v: trainers["pallas"].init_state(torch.Generator().manual_seed(0)) for v in vjps}
    states["conv2d"] = trainers["conv2d"].init_state(torch.Generator().manual_seed(0))
    states["conv2d"].module.load_state_dict(final_conv_as_plain(
        states["pallas"].module.state_dict()))
    batch = next(trainers["pallas"].synthetic_data(batch_size=1, seed=0))
    draws = torch.tensor([[0.37, -0.61, 0.18]], device=dev)
    order = ["conv2d", *vjps]

    def step(v):
        conv3d_cuda.conv3d_k3_vjp = vjps.get(v, own_vjp)
        tr = trainers["conv2d" if v == "conv2d" else "pallas"]
        tr.train_step(states[v], batch, draws=draws)

    try:
        for v in order:
            for _ in range(3):
                step(v)
        dev_ms = {v: [] for v in order}
        wall = {v: [] for v in order}
        for i in range(ROUNDS):
            for v in (order if i % 2 == 0 else order[::-1]):
                dev_ms[v].append(device_ms(lambda: step(v)))
                wall[v].append(wall_ms(lambda: step(v)))
    finally:
        conv3d_cuda.conv3d_k3_vjp = own_vjp
    for v in order:
        faster = sum(a < b for a, b in zip(dev_ms[v], dev_ms["conv2d"]))
        print(json.dumps({"step": v, "rounds": ROUNDS, "device_ms": quartiles(dev_ms[v]),
                          "wall_ms": quartiles(wall[v]), "device_faster_than_conv2d": faster,
                          "card": name}), flush=True)
    if args.against is None:
        return
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, 100, 100, 100, 128, generator=gen, device=dev).bfloat16()
    w = (torch.randn(3, 3, 3, 128, 64, generator=gen, device=dev) * 0.03).bfloat16()
    g = torch.randn(1, 100, 100, 100, 64, generator=gen, device=dev).bfloat16()
    times = {v: [] for v in vjps}
    with torch.no_grad():
        for i in range(ROUNDS):
            for v in (list(vjps) if i % 2 == 0 else list(vjps)[::-1]):
                times[v].append(event_ms(lambda: vjps[v](x, w, g), reps=10))
    faster = sum(a < b for a, b in zip(times["pallas"], times["pallas_against"]))
    print(json.dumps({"vjp_ms": {v: quartiles(t) for v, t in times.items()},
                      "rounds": ROUNDS, "this_tree_faster": faster, "card": name}),
          flush=True)


if __name__ == "__main__":
    main()
