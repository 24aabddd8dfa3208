"""Device-time profile of the serving policy's forward (counterpart of
scripts/profile_policy.py).

Traces `n_inner` forwards and argmax decodes of configs/serve.yaml's
policy (UNet encoder, 100^3 x 10 voxels, 2048 x 512 latents, depth 6,
bf16; random weights from seed 0) through `utils.profiling.trace`, reads
the Chrome trace it writes, sums the device time of the CUDA lanes
(kernels, copies, sets) by op class and by op, and prints the top entries
per forward:

    python -m real_robot_nerf_actor_tpu_torch.tools.profile_policy \
        [--plain] [--dtype bfloat16] [--out DIR] [--n-inner 4] [--top 25]
        [--upsample-mode MODE] [--conv-backend NAME] [--pointwise]
        [--shuffle-transpose]

--plain runs the plain versions in place of the hand-written kernels
(flash attention, the k3 conv, the spatial stats). --upsample-mode and
--conv-backend override PerceiverConfig (after --plain). --pointwise and
--shuffle-transpose are the script's TPU lowering switches: the port runs
those lowerings as the maths they compute, so both are accepted and change
nothing. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, Optional, Sequence

# the policy of configs/serve.yaml (section peract.model; a CPU test holds
# the two equal: the card's machine has no PyYAML)
SERVE_POLICY = dict(depth=6, voxel_size=100, initial_dim=10, num_latents=2048,
                    latent_dim=512, input_encoder="unet", return_voxel_feat=True,
                    compute_dtype="bfloat16")
KERNEL_KNOBS = dict(use_flash_attention=True, conv_backend="pallas",
                    stats_backend="pallas")

# op class by the first pattern a kernel's name matches
CLASSES = [
    ("flash_attention", r"flash_"),
    ("conv3d_k3", r"conv3d_k3"),
    ("spatial_stats", r"stats_kernel|spatial_stats"),
    ("port kernel", r"corner_lerp|ray_expand|resnetfc"),
    ("gemm", r"gemm|xmma|cutlass|sm90_|sm80_|ampere_|cublas"),
    ("convolution", r"conv|implicit_convolve|fprop|dgrad|wgrad|winograd|cudnn"),
    ("reduction", r"reduce|norm|softmax|argmax|amax|welford"),
    ("scatter/gather", r"index|scatter|gather"),
    ("copy", r"memcpy|copy|cat|transpose|permute"),
    ("set", r"memset|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def op_class(name: str) -> str:
    low = name.lower()
    for cls, pat in CLASSES:
        if re.search(pat, low):
            return cls
    return "other"


def aggregate_trace(path: str):
    """(total ms, {class: ms}, {op: ms}) of the device-side events of a
    Chrome trace written by torch.profiler: kernels, copies and sets."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ms = e.get("dur", 0) / 1e3
        by_name[e["name"]] += ms
        by_class[op_class(e["name"])] += ms
        total += ms
    return total, dict(by_class), dict(by_name)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plain", action="store_true",
                    help="the plain versions in place of the hand-written kernels")
    ap.add_argument("--dtype", default=SERVE_POLICY["compute_dtype"])
    ap.add_argument("--out", default=None, help="trace directory (default: a temporary one)")
    ap.add_argument("--n-inner", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--upsample-mode", default=None,
                    help="override PerceiverConfig.upsample_mode")
    ap.add_argument("--conv-backend", default=None,
                    help="override PerceiverConfig.conv_backend (xla|pallas|conv2d)")
    ap.add_argument("--pointwise", action="store_true",
                    help="accepted, no effect: the port computes the pointwise "
                         "conv lowering as the plain conv")
    ap.add_argument("--shuffle-transpose", action="store_true",
                    help="accepted, no effect: the port computes the shuffled "
                         "transposed-conv lowering as the plain transposed conv")
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace):
    """The PerceiverConfig the tool profiles: serve.yaml's policy in
    args.dtype, the kernel knobs unless --plain, then the overrides."""
    from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig

    kw = {**SERVE_POLICY, "compute_dtype": args.dtype,
          **({} if args.plain else KERNEL_KNOBS)}
    if args.upsample_mode:
        kw["upsample_mode"] = args.upsample_mode
    if args.conv_backend:
        kw["conv_backend"] = args.conv_backend
    return PerceiverConfig(**kw)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)

    import torch
    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    from real_robot_nerf_actor_tpu_torch.models.blocks import Conv3DBlock
    from real_robot_nerf_actor_tpu_torch.ops import choose_highest_action
    from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
    from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope, trace

    dev = resolve_device("cuda")
    cfg = build_config(args)
    net = PerceiverIO.initialized(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    for m in net.modules():
        if isinstance(m, Conv3DBlock):
            m.cast_kernel_()
    g = torch.Generator(device=dev).manual_seed(1)
    v = cfg.voxel_size
    vox = torch.randn((1, v, v, v, cfg.initial_dim), generator=g, device=dev)
    proprio = torch.zeros((1, cfg.low_dim_size), device=dev)
    lang = torch.randn((1, cfg.lang_max_seq_len, cfg.lang_emb_dim), generator=g, device=dev)

    def act(i):
        with named_scope("model_inference"):
            q_trans, q_rot_grip, q_coll = net(vox + i * 1e-6, proprio, lang)[:3]
        return choose_highest_action(q_trans, q_rot_grip, q_coll)

    with torch.inference_mode():
        act(0)
        torch.cuda.synchronize()
        out = args.out or tempfile.mkdtemp(prefix="policy_trace_")
        with trace(out):
            for i in range(args.n_inner):
                act(i)
    total, by_class, by_name = aggregate_trace(os.path.join(out, "trace.json"))
    n = args.n_inner
    summary = dict(
        trace=os.path.join(out, "trace.json"), n_inner=n, device_ms_per_forward=total / n,
        path="plain" if args.plain else "kernels", dtype=args.dtype,
        by_class=[{"class": k, "ms": v / n} for k, v in
                  sorted(by_class.items(), key=lambda kv: -kv[1])],
        top=[{"op": k[:100], "ms": v / n} for k, v in
             sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]])
    print(f"\ndevice total {total:.3f} ms over {n} forwards = "
          f"{total / n:.3f} ms/action ({summary['path']}, {args.dtype})\n")
    print("-- by op class (ms, per action) --")
    for r in summary["by_class"]:
        print(f"  {r['class']:28s} {r['ms']:8.3f}")
    print(f"\n-- top {args.top} ops (ms, per action) --")
    for r in summary["top"]:
        print(f"  {r['op'][:72]:72s} {r['ms']:8.3f}")
    return summary


if __name__ == "__main__":
    main()
