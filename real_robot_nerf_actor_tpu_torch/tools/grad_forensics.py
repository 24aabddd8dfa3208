"""Gradient forensics for non-finite update bursts (the counterpart of
scripts/grad_forensics.py, with its four modes and its flags).

A run whose optimizer drops non-finite updates (`OptimConfig.skip_nonfinite`)
counts them in `Optimizer.total_notfinite`. This tool finds where they come
from, on the NeRF-Actor joint step (`NerfActTrainer.train_step`) of a
multi-kitchen run:

  replay   restore a checkpoint of the run at --from-step (the latest
           without it), fast-forward the data and the step draws to that
           step, and run the unmodified train_step for --replay-steps
           steps: the replay is the run. Every step on which
           total_notfinite rises is an event; the first --max-stash events
           are stashed (stash_step<N>.npz: the module's pre-step state_dict,
           BatchNorm buffers included, the batch, and the generator's state
           before the step, from which the step's draws come again). Writes
           events.json: from_step, the events, the stashes and every step's
           metrics at the step number the Trainer logs them under.
  dissect  on a stash: the four loss terms (loss_trans, loss_rot_grip,
           loss_trans_aux, loss_render), their gradients one weighted
           backward per term (a one-hot weight over the four: the zero
           weights still carry their cotangents through the other terms'
           graphs, as the JAX tool's one-hot gradient does), the parameters
           each term leaves non-finite, the same from each term's own graph
           alone (`nonfinite_alone`: where the non-finite values start), and
           four forward probes (largest |q_trans|, |q_rot_grip|,
           |voxel_feat|, |q_trans_aux|). Writes <stash>_dissect.json.
  probe    on a stash: every float output of every module of the policy's
           train-mode forward (forward hooks), with its non-finite count
           and its largest finite magnitude. Non-finite outputs come first,
           in the order the forward produced them, so the first row is
           where the forward first went non-finite; then the finite ones by
           magnitude.
  mint     on a stash: each segment of the policy alone (the encoder, the
           cross-attention and its feed-forward, each latent block, the
           decoder cross-attention, up0, final, the trans decoder, the
           spatial softmax of d0, dec and u), on the inputs it received in
           the forward (hooks), its VJP taken alone; then the whole
           network's backward of its head sums and of the BC losses. The
           first non-finite segment in forward order is named. Attention
           runs on the plain path: flash_attention has no backward in the
           port (ops/_grad.refuse_grad), as in training.

    python -m real_robot_nerf_actor_tpu_torch.tools.grad_forensics --mode replay \\
        --config CFG --multi-root DATA --ckpt-dir CKPT --replay-steps 100 --out DIR
    python -m real_robot_nerf_actor_tpu_torch.tools.grad_forensics --mode dissect \\
        --config CFG --multi-root DATA --stash DIR/stash_step<N>.npz

The step's draws: `Trainer.run` draws the weights and then every step's
randomness from one torch.Generator seeded with the config's seed, and that
generator is not in the checkpoint. The replay seeds it, draws the weights
(init_state), records the torch calls that draw from a generator during one
throwaway step (`DrawTape`, a TorchFunctionMode; the state is restored after
it) and calls them again once per skipped step: the generator then stands
where an unbroken run had it, with no step computed. Every replayed step is
checked to draw exactly what was recorded. Entry points run on the card
unless --device cpu.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

TERMS = ("loss_trans", "loss_rot_grip", "loss_trans_aux", "loss_render")


class DrawTape(TorchFunctionMode):
    """Records each torch call that draws from `generator` (its function,
    arguments and keyword arguments but the generator), and refuses a draw
    with a tensor argument: such a draw may consume the generator by what
    the tensor holds, so it cannot be replayed from the shapes alone."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.generator = generator
        self.calls: List[tuple] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("generator") is self.generator:
            rest = {k: v for k, v in kwargs.items() if k != "generator"}
            if any(torch.is_tensor(a) for a in (*args, *rest.values())):
                raise RuntimeError(f"{func.__name__} draws from the step's generator with a "
                                   "tensor argument: its draws cannot be replayed")
            self.calls.append((func, args, rest))
        return func(*args, **kwargs)

    def signature(self) -> List[tuple]:
        return [(f.__name__, repr(a), repr(sorted(k.items()))) for f, a, k in self.calls]

    def redraw(self, generator: torch.Generator) -> None:
        """Make every recorded draw again from `generator`, discarding it."""
        for func, args, kwargs in self.calls:
            func(*args, generator=generator, **kwargs)


def build(args):
    """The trainer of the config and the dataset's entries."""
    from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    cfg = load_config(NerfActConfig, args.config, args.override)
    tr = NerfActTrainer(cfg, device=args.device)
    exclude = tuple(int(x) for x in args.exclude_demos.split(",") if x)
    return tr, load_multitask_entries(args.multi_root, exclude_demos=exclude)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def replay(args) -> dict:
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager

    tr, entries = build(args)
    tcfg = tr.cfg.train
    data = tr.multi_replay_data(entries, args.batch_size)
    mgr = CheckpointManager(args.ckpt_dir)
    from_step = args.from_step if args.from_step is not None else mgr.latest_step()
    if from_step is None:
        raise SystemExit(f"no checkpoint in {args.ckpt_dir}")

    # the generator as Trainer.run has it after the weights: seeded, then init_state
    generator = torch.Generator().manual_seed(tcfg.seed)
    state = tr.init_state(generator)
    if mgr.restore(state, step=from_step) is None or state.step != from_step:
        raise SystemExit(f"no checkpoint of step {from_step} in {args.ckpt_dir}")
    if state.optimizer.total_notfinite is None:
        raise SystemExit("replay needs peract.train.optim.skip_nonfinite > 0: "
                         "without it the optimizer counts no non-finite update")
    print(f"[replay] restored step {from_step} from {args.ckpt_dir}")

    # one step's draws, recorded on a throwaway step; the state is restored after it
    first = next(data)
    tape = DrawTape(torch.Generator().manual_seed(0))
    with tape:
        tr.train_step(state, first, tape.generator)
    mgr.restore(state, step=from_step)
    batches = itertools.chain([first], data)
    for _ in range(from_step):
        next(batches)
        tape.redraw(generator)
    print(f"[replay] fast-forwarded {from_step} batches and {from_step} x "
          f"{len(tape.calls)} draws")

    os.makedirs(args.out, exist_ok=True)
    tn_prev = state.optimizer.total_notfinite
    events, stashes, metrics_log = [], [], []
    for step in range(from_step, from_step + args.replay_steps):
        batch = next(batches)
        pre = {k: v.detach().clone() for k, v in state.module.state_dict().items()}
        gen_state = generator.get_state()
        check = DrawTape(generator)
        with check:
            state, metrics = tr.train_step(state, batch, generator)
        if check.signature() != tape.signature():
            raise RuntimeError(f"step {step} drew {check.signature()}, the recorded step "
                               f"{tape.signature()}: the fast-forward does not hold")
        m = {k: float(v) for k, v in metrics.items()}
        tn = state.optimizer.total_notfinite
        metrics_log.append({"step": step + 1, **m, "grad_skips": float(tn)})
        if tn > tn_prev:
            events.append(step)
            print(f"[replay] step {step}: NONFINITE grad (total {tn_prev} -> {tn}), "
                  f"loss={m['loss_total']:.3f}")
            if len(stashes) < args.max_stash:
                path = os.path.join(args.out, f"stash_step{step}.npz")
                payload = {f"batch/{k}": _numpy(v) for k, v in batch.items()}
                payload.update({f"module/{k}": _numpy(v) for k, v in pre.items()})
                payload["generator_state"] = gen_state.numpy()
                payload["step"] = np.asarray(step)
                np.savez(path, **payload)
                print(f"[replay] stashed the pre-step state, batch and draws -> {path}")
                stashes.append(path)
        elif (step + 1) % 50 == 0:
            print(f"[replay] step {step + 1} ok | loss={m['loss_total']:.3f} | skips={tn}")
        tn_prev = tn
    record = {"from_step": from_step, "events": events, "stashes": stashes,
              "metrics": metrics_log}
    with open(os.path.join(args.out, "events.json"), "w") as f:
        json.dump(record, f)
    print(f"[replay] done: {len(events)} nonfinite steps in "
          f"[{from_step}, {from_step + args.replay_steps})")
    return record


def load_stash(args):
    """(trainer, state on the stash's pre-step weights and buffers, batch,
    the generator at the step's draws, step)."""
    tr, _ = build(args)
    with np.load(args.stash) as z:
        arrays = {k: z[k] for k in z.files}
    state = tr.init_state(torch.Generator().manual_seed(0))
    sd = state.module.state_dict()
    flat = {k[len("module/"):]: v for k, v in arrays.items() if k.startswith("module/")}
    if set(flat) != set(sd):
        raise ValueError(f"{args.stash}: its state_dict keys are not this config's "
                         f"({sorted(set(flat) ^ set(sd))[:5]} ...)")
    state.module.load_state_dict({k: torch.from_numpy(flat[k]).to(sd[k].dtype) for k in sd})
    batch = {k[len("batch/"):]: torch.from_numpy(v).to(tr.device)
             for k, v in arrays.items() if k.startswith("batch/")}
    generator = torch.Generator()
    generator.set_state(torch.from_numpy(arrays["generator_state"]))
    step = int(arrays["step"])
    print(f"[stash] step {step}, {len(flat)} state_dict entries")
    return tr, state, batch, generator, step


def loss_terms(tr, state, batch, generator, draws: Optional[dict] = None):
    """The train step's forward on the stash: the four terms (a list of
    scalars, in the graph) and the forward probes (4,). draws: train_step's
    draws=, ray_idx= and render_draws= (else from `generator`, as the step
    drew them)."""
    _, metrics, out = tr.losses(state, batch, generator, **(draws or {}))
    zero = torch.zeros((), device=tr.device)
    terms = [metrics.get(t, zero).float() for t in TERMS]
    aux = out[4].float().abs().max() if tr.cfg.model.aux_trans_head else zero
    probes = torch.stack([out[0].float().abs().max(), out[1].float().abs().max(),
                          out[3].float().abs().max(), aux])
    return terms, probes


def _bad_leaves(names, grads) -> List[tuple]:
    rows = []
    for name, g in zip(names, grads):
        if g is None:
            continue
        finite = torch.isfinite(g)
        bad = int(g.numel() - finite.sum())
        if bad:
            fin = g[finite]
            rows.append((name, bad, float(fin.abs().max()) if fin.numel() else 0.0))
    return rows


def dissect(args, draws: Optional[dict] = None, keep_grads: bool = False) -> dict:
    """The dissect report; with keep_grads, also each term's gradients by
    parameter name (None where a term does not reach a parameter)."""
    tr, state, batch, generator, _ = load_stash(args)
    named = list(state.module.named_parameters())
    names, params = [n for n, _ in named], [p for _, p in named]
    terms, probes = loss_terms(tr, state, batch, generator, draws)
    stacked = torch.stack(terms)
    report, alone, grads = {}, {}, {}
    for i, t in enumerate(TERMS):
        w = torch.zeros(len(TERMS), device=stacked.device)
        w[i] = 1.0
        g = torch.autograd.grad((w * stacked).sum(), params, retain_graph=True,
                                allow_unused=True)
        rows = _bad_leaves(names, g)
        if rows:
            report[t] = sorted(rows, key=lambda r: -r[1])
        if keep_grads:
            grads[t] = dict(zip(names, g))
        # the term's own graph only: no zero cotangent enters the others'
        if terms[i].requires_grad:
            rows = _bad_leaves(names, torch.autograd.grad(terms[i], params, retain_graph=True,
                                                          allow_unused=True))
            if rows:
                alone[t] = sorted(rows, key=lambda r: -r[1])
    del stacked
    terms = [float(v.detach()) for v in terms]
    probes = probes.detach().cpu().tolist()
    print("[dissect] loss terms: " + ", ".join(f"{t}={v:.3f}" for t, v in zip(TERMS, terms)))
    print(f"[dissect] forward probes: max|q_trans|={probes[0]:.1f} "
          f"max|q_rot_grip|={probes[1]:.1f} max|voxel_feat|={probes[2]:.1f} "
          f"max|q_trans_aux|={probes[3]:.1f}")
    if not report:
        print("[dissect] NO nonfinite per-term gradients")
    for t, rows in report.items():
        print(f"[dissect] term {t}: {len(rows)} leaves nonfinite "
              f"({len(alone.get(t, []))} by its own graph alone)")
        for name, bad, mx in rows[:12]:
            print(f"    {name}: {bad} bad, max|finite|={mx:.3e}")
    out = {"terms": dict(zip(TERMS, terms)), "probes": probes,
           "nonfinite": {t: [list(r) for r in rows] for t, rows in report.items()},
           "nonfinite_alone": {t: [list(r) for r in rows] for t, rows in alone.items()}}
    with open(args.stash.replace(".npz", "_dissect.json"), "w") as f:
        json.dump(out, f, indent=1)
    if keep_grads:
        out["grads"] = grads
    return out


def _float_outputs(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(j, o) for j, o in enumerate(outs)
            if torch.is_tensor(o) and o.is_floating_point()]


def probe(args) -> List[dict]:
    tr, state, batch, generator, _ = load_stash(args)
    policy = state.module["policy"]
    rows: List[dict] = []

    def hook(name):
        def fn(module, inputs, out):
            outs = _float_outputs(out)
            for j, o in outs:
                finite = torch.isfinite(o)
                fin = o[finite]
                rows.append({"name": name + (f"/{j}" if len(outs) > 1 else ""),
                             "bad": int(o.numel() - finite.sum()),
                             "max": float(fin.abs().max()) if fin.numel() else float("nan"),
                             "dtype": str(o.dtype).split(".")[-1], "size": o.numel(),
                             "order": len(rows)})
        return fn

    handles = [m.register_forward_hook(hook(n or "policy")) for n, m in policy.named_modules()]
    try:
        with torch.no_grad():
            tr._forward_bc(policy, batch, generator)
    finally:
        for h in handles:
            h.remove()
    rows.sort(key=lambda r: (0, r["order"]) if r["bad"] else (1, -r["max"]))
    print(f"[probe] {len(rows)} float module outputs")
    for r in rows[:30]:
        flag = " <-- NONFINITE" if r["bad"] else ""
        print(f"  {r['name']}: bad={r['bad']}/{r['size']} max|finite|={r['max']:.3e} "
              f"{r['dtype']}{flag}")
    return rows


def mint(args) -> dict:
    from real_robot_nerf_actor_tpu_torch.models.perceiver import MHAttention
    from real_robot_nerf_actor_tpu_torch.ops.spatial_softmax import spatial_softmax_3d

    tr, state, batch, generator, _ = load_stash(args)
    policy = state.module["policy"]
    c = tr.cfg.model
    flash = [m for m in policy.modules() if isinstance(m, MHAttention) and m.use_flash]
    for m in flash:
        m.use_flash = False
    if flash:
        print(f"[mint] {len(flash)} attention modules run on the plain path: "
              "flash_attention has no backward in the port")
    segments = (["encoder_3d" if c.input_encoder == "unet" else "input_preprocess",
                 "cross_attend", "cross_ff"]
                + [f"self_{k}_{i}" for i in range(c.depth) for k in ("attn", "ff")]
                + ["decoder_cross_attn", "up0", "final", "trans_decoder"])
    seen: Dict[str, tuple] = {}

    def hook(name):
        def fn(module, a, kw, out):
            seen[name] = (a, kw, out)
        return fn

    handles = [getattr(policy, n).register_forward_hook(hook(n), with_kwargs=True)
               for n in segments]
    try:
        with torch.no_grad():
            tr._forward_bc(policy, batch, generator)
    finally:
        for h in handles:
            h.remove()

    rows: List[dict] = []

    def check(label, grads):
        grads = [g for g in grads if g is not None]
        ok = all(bool(torch.isfinite(g).all()) for g in grads)
        mx = max((float(g.abs().max()) for g in grads), default=0.0)
        print(f"[mint] {label}: {'FINITE' if ok else 'NONFINITE <--'} max|g|={mx:.3e}")
        rows.append({"segment": label, "finite": ok, "max_abs_grad": mx})

    def leaf(x):
        return (x.detach().clone().requires_grad_(True)
                if torch.is_tensor(x) and x.is_floating_point() else x)

    for name in segments:
        a, kw, _ = seen[name]
        a = [leaf(x) for x in a]
        inputs = [x for x in a if torch.is_tensor(x) and x.requires_grad]
        out = getattr(policy, name)(*a, **kw)
        check(f"{name}(x)", torch.autograd.grad(out.float().sum(), inputs, allow_unused=True))

    # the spatial softmax on the exact volumes, plain and randomly weighted
    s = c.spatial_size
    dec = seen["decoder_cross_attn"][2][:, c.lang_max_seq_len:]
    dec = dec.reshape(dec.shape[0], s, s, s, c.input_dim_before_seq)
    g_w = torch.Generator().manual_seed(1)
    for label, vol in (("ssm(d0)", seen[segments[0]][2]), ("ssm(dec)", dec),
                       ("ssm(u)", seen["final"][2])):
        x = leaf(vol)
        check(label, torch.autograd.grad(spatial_softmax_3d(x).float().sum(), [x]))
        w = torch.randn((vol.shape[0], vol.shape[-1] * 3), generator=g_w).to(vol.device)
        check(label + " (rand-weighted)",
              torch.autograd.grad((w * spatial_softmax_3d(x).float()).sum(), [x]))

    # the whole network's backward without the render: head sums, then the BC losses
    params = [p for p in policy.parameters()]
    gen_state = generator.get_state()
    out = tr._forward_bc(policy, batch, generator)[0]
    heads = [out[0], out[1], out[2]] + ([out[4]] if c.aux_trans_head else [])
    check("FULL network backward (head sums, no losses)",
          torch.autograd.grad(sum(o.float().sum() for o in heads), params, allow_unused=True))
    generator.set_state(gen_state)
    bc_total = tr._forward_bc(policy, batch, generator)[2]
    check("bc losses backward (NO renderer)",
          torch.autograd.grad(bc_total, params, allow_unused=True))
    first = next((r["segment"] for r in rows if not r["finite"]), None)
    print(f"[mint] first nonfinite segment: {first}")
    return {"rows": rows, "first_nonfinite": first}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["replay", "dissect", "probe", "mint"], required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--multi-root", required=True)
    ap.add_argument("--exclude-demos", default="")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--from-step", type=int, default=None)
    ap.add_argument("--replay-steps", type=int, default=1000)
    ap.add_argument("--max-stash", type=int, default=2)
    ap.add_argument("--out", default="gradf")
    ap.add_argument("--stash", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "replay":
        if not args.ckpt_dir:
            ap.error("--mode replay needs --ckpt-dir")
        return replay(args)
    if not args.stash:
        ap.error(f"--mode {args.mode} needs --stash")
    return {"dissect": dissect, "probe": probe, "mint": mint}[args.mode](args)


if __name__ == "__main__":
    main()
