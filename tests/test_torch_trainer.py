"""The trainer runtime of the PyTorch port against the JAX package's: the
learning-rate schedules against optax's, the optimizer chain against
`make_optimizer` on identical gradients (every branch: schedules, global
norm clipping, MultiSteps accumulation, apply_if_finite with its
over-limit branch), the converter of a JAX optimizer state, the prefetch
iterator's error path, and checkpoint retention and resume.

Tolerance: after t steps, parameters within 1e-6 relative plus 2e-5 lr
per step taken (absolute). The algorithm is the same; its rounding is
not. optax evaluates the bias correction 1 - b2^t in fp32 (XLA's pow),
up to 7.4e-6 of its value (t <= 20) below what torch's AdamW computes in
float64 from the same fp32 b2, so optax's update is up to 3.7e-6 of
itself smaller, always in the same direction; an Adam update is at most
~3 lr, so the two drift apart by up to ~1.1e-5 lr a step, plus the
decay's rounding (torch's p (1 - lr wd) against optax's lr (u + wd p))
and the clip's (max / |g| against (g / |g|) max). Measured over these
chains: at most 7.9e-6 lr a step, 9.2e-5 lr after 20 steps. Entries far
from zero hold 1e-6 relative throughout. A wrong schedule value, bias
correction or clip moves an update by far more than 2e-5 of it.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real_robot_nerf_actor_tpu.train.trainer import OptimConfig as JaxOptim
from real_robot_nerf_actor_tpu.train.trainer import make_optimizer
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict, load_optax_state
from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
from real_robot_nerf_actor_tpu_torch.train.trainer import (
    CheckpointManager, OptimConfig, Optimizer, TrainConfig, make_schedule,
    prefetch_iterator)

SCHEDULES = {
    "constant": dict(lr=1e-2),
    "cosine_warmup": dict(lr=1e-2, schedule="cosine", warmup_steps=4, decay_steps=15),
    "cosine": dict(lr=1e-2, schedule="cosine", decay_steps=15, min_lr_frac=0.1),
    "exponential": dict(lr=1e-2, lr_decay_rate=0.1),
}


def _optax_schedule(cfg: JaxOptim):
    """The schedule `make_optimizer` builds for cfg (trainer.py:120-128)."""
    if cfg.schedule == "cosine":
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0 if cfg.warmup_steps > 0 else cfg.lr, peak_value=cfg.lr,
            warmup_steps=max(cfg.warmup_steps, 1), decay_steps=cfg.decay_steps,
            end_value=cfg.min_lr_frac * cfg.lr)
    if cfg.lr_decay_rate > 0:
        return optax.exponential_decay(cfg.lr, 1, 1.0 - cfg.lr_decay_rate)
    return lambda count: cfg.lr


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name):
    """50 counts, past the end of the cosine's decay."""
    ours = make_schedule(OptimConfig(**SCHEDULES[name]))
    want = _optax_schedule(JaxOptim(**SCHEDULES[name]))
    for count in range(50):
        np.testing.assert_allclose(ours(count), float(want(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6, err_msg=f"count {count}")
    if name == "cosine_warmup":
        assert ours(0) == 0.0


# ------------------------------------------------------------- the chain
def _params(seed=0):
    """A small flax-layout params tree: a Dense, a transposed conv (flipped
    by the converter) and a k3 kernel kept in the flax layout."""
    rng = np.random.default_rng(seed)
    shapes = {"dense": {"kernel": (5, 4), "bias": (4,)},
              "up0": {"ConvTranspose_0": {"kernel": (2, 2, 2, 3, 2)}},
              "final": {"pallas_kernel": (3, 3, 3, 2, 3), "pallas_bias": (3,)}}
    return jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))


def _grads(params, steps, seed=1, scales=None, bad=None):
    """One gradient tree per step: N(0, scale_t^2) entries; bad maps a
    step to a value (NaN or +-Inf) put in one entry of the Dense kernel."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        s = 1.0 if scales is None else scales[t % len(scales)]
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * s,
                         params)
        if bad and t in bad:
            g["dense"]["kernel"][1, 2] = bad[t]
        out.append(jax.tree.map(jnp.asarray, g))
    return out


def _port(params, cfg):
    named = [(n, torch.nn.Parameter(t)) for n, t in
             flax_to_state_dict({"params": params}).items()]
    return Optimizer(OptimConfig(**cfg), named), dict(named)


def _port_step(opt, named, grads):
    for n, g in flax_to_state_dict({"params": grads}).items():
        named[n].grad = g
    opt.step()


def _assert_params(named, params, lr, steps):
    for n, w in flax_to_state_dict({"params": params}).items():
        np.testing.assert_allclose(named[n].detach().numpy(), w.numpy(), rtol=1e-6,
                                   atol=2e-5 * lr * steps, err_msg=f"step {steps} {n}")


CHAINS = {
    **SCHEDULES,
    "adam": dict(lr=1e-2, name="adam", weight_decay=0.1),
    "weight_decay": dict(lr=1e-2, weight_decay=0.3),
    # the decay follows the scheduled lr (zero on the first update)
    "weight_decay_warmup": dict(lr=1e-2, weight_decay=0.3, schedule="cosine",
                                warmup_steps=4, decay_steps=15),
    "grad_clip": dict(lr=1e-2, grad_clip=1.0),
    "accum_3": dict(lr=1e-2, accum_steps=3),
    # NaN/Inf gradients: steps 3, 4, 5 in a row (the third is over the
    # limit of 2 and is applied), then single ones at 9 and 14 (dropped)
    "nonfinite": dict(lr=1e-2, skip_nonfinite=2),
    "accum_nonfinite": dict(lr=1e-2, accum_steps=3, skip_nonfinite=2, grad_clip=2.0),
}
BAD = {3: np.nan, 4: np.inf, 5: -np.inf, 9: np.nan, 14: np.inf}


@pytest.mark.parametrize("name", list(CHAINS))
def test_optimizer_matches_make_optimizer(name):
    """20 steps on identical gradients: the parameters after every step,
    and grad_skips (optax's total_notfinite)."""
    cfg = CHAINS[name]
    params = _params()
    scales = [0.05, 2.0, 0.1] if cfg.get("grad_clip") else None
    bad = {"nonfinite": BAD, "accum_nonfinite": {4: np.nan, 9: np.inf}}.get(name)
    grads = _grads(params, 20, scales=scales, bad=bad)
    tx = make_optimizer(JaxOptim(**cfg))
    update = jax.jit(tx.update)
    state = tx.init(params)
    opt, named = _port(params, cfg)
    for t, g in enumerate(grads):
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        _port_step(opt, named, g)
        _assert_params(named, params, cfg["lr"], t + 1)
        assert opt.total_notfinite == int(state.total_notfinite), t
        assert opt.notfinite_count == int(state.notfinite_count), t
    if name == "nonfinite":    # the over-limit step let the Inf through
        assert np.isnan(np.asarray(params["dense"]["kernel"])[1, 2])
        assert opt.total_notfinite == 5
    if name == "accum_nonfinite":
        assert opt.total_notfinite == 2 and opt.gradient_step == 6


def test_clip_fires_only_over_the_limit():
    """The clip case's gradients are on both sides of grad_clip."""
    params = _params()
    norms = [float(optax.global_norm(g)) for g in _grads(params, 6, scales=[0.05, 2.0, 0.1])]
    assert min(norms) < 1.0 < max(norms)


@pytest.mark.parametrize("name", ["default", "accum_clip_cosine"])
def test_converted_optax_state_resumes_on_the_same_trajectory(name):
    """A JAX optimizer state after 3 steps, carried into the port by
    convert.load_optax_state with the parameters, then 2 more steps in
    each package on the same gradients."""
    cfg = {"default": dict(lr=1e-2),
           "accum_clip_cosine": dict(lr=1e-2, accum_steps=2, grad_clip=1.0,
                                     schedule="cosine", warmup_steps=1, decay_steps=6)}[name]
    params = _params()
    grads = _grads(params, 5, scales=[0.5, 2.0])
    tx = make_optimizer(JaxOptim(**cfg))
    update = jax.jit(tx.update)
    state = tx.init(params)
    for g in grads[:3]:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    opt, named = _port(params, cfg)
    load_optax_state(opt, jax.tree.map(np.asarray, state))
    assert opt.count == (1 if cfg.get("accum_steps") else 3)
    for t, g in enumerate(grads[3:], start=4):
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        _port_step(opt, named, g)
        _assert_params(named, params, cfg["lr"], t)
    if cfg.get("accum_steps"):
        assert (opt.mini_step, opt.gradient_step) == (int(state.inner_state.mini_step),
                                                      int(state.inner_state.gradient_step))


# ------------------------------------------------------------- runtime
def test_prefetch_iterator_raises_the_workers_error():
    def batches():
        yield 1
        yield 2
        raise KeyError("worker failed")

    it = prefetch_iterator(batches(), depth=2)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match="worker failed"):
        next(it)
    assert list(prefetch_iterator(iter([1, 2, 3]), depth=1)) == [1, 2, 3]


def _tiny(tmp_path, **train_kw):
    model = PerceiverConfig(depth=1, voxel_size=10, num_latents=32, latent_dim=64,
                            im_channels=8, cross_dim_head=16, latent_dim_head=16,
                            latent_heads=2, voxel_patch_size=5, final_dim=8,
                            lang_emb_dim=16, lang_max_seq_len=4)
    kw = dict(num_steps=6, log_every=2, ckpt_every=2, eval_every=2,
              ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log"),
              best_key="score", prefetch=1)
    kw.update(train_kw)
    return PerActTrainer(PerActConfig(model=model,
                                      voxelizer=VoxelizerSpec(voxel_size=10,
                                                              max_num_coords=2000),
                                      train=TrainConfig(**kw)), device="cpu")


def test_checkpoints_keep_latest_backup_and_best(tmp_path):
    """ckpt_every 2 over 6 steps keeps steps 4 and 6; the best eval score
    (step 4 of 2, 4, 6) is kept in <ckpt_dir>_best; the log has the
    metrics, grad_skips and steps_per_sec; a resumed run continues from
    step 6 with the saved weights and optimizer."""
    tr = _tiny(tmp_path)
    scores = {2: 1.0, 4: 3.0, 6: 2.0}
    trainer = tr.make_trainer()
    trainer.eval_fn = lambda state, step: {"score": scores[step]}
    state = trainer.run()
    assert state.step == 6
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [4, 6]
    best = CheckpointManager(str(tmp_path / "ckpt_best"))
    assert best.all_steps() == [4]
    assert json.loads((tmp_path / "ckpt_best" / "best.json").read_text()) == {
        "key": "score", "value": 3.0, "step": 4}
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["category"] == "train"]
    assert [r["step"] for r in train] == [2, 4, 6]
    assert {"loss", "loss_trans", "grad_skips", "steps_per_sec"} <= set(train[0])

    saved = {k: v.clone() for k, v in state.module.state_dict().items()}
    adam_steps = state.optimizer.count
    tr2 = _tiny(tmp_path, num_steps=6)
    resumed = tr2.make_trainer().run()
    assert resumed.step == 6 and resumed.optimizer.count == adam_steps
    for k, v in resumed.module.state_dict().items():
        assert torch.equal(v, saved[k]), k
    m = resumed.optimizer.adamw.state[next(resumed.module.parameters())]["exp_avg"]
    assert m.abs().max() > 0


def test_resume_params_only_when_the_optimizer_changed(tmp_path, capsys):
    """A fine-tune that adds accumulation cannot take the saved optimizer
    state: the run restores the params and the step and starts its
    optimizer fresh; restore(params_only=True) and restore_raw_params give
    the saved weights."""
    state = _tiny(tmp_path, num_steps=4).make_trainer().run()
    saved = {k: v.clone() for k, v in state.module.state_dict().items()}
    cfg = _tiny(tmp_path, num_steps=4).cfg
    tr = PerActTrainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optim=OptimConfig(accum_steps=2))), device="cpu")
    resumed = tr.make_trainer().run()
    assert "retrying params-only" in capsys.readouterr().out
    assert resumed.step == 4 and resumed.optimizer.count == 0
    for k, v in resumed.module.state_dict().items():
        assert torch.equal(v, saved[k]), k
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="optimizer"):
        mgr.restore(tr.init_state(torch.Generator().manual_seed(3)))
    fresh = tr.init_state(torch.Generator().manual_seed(3))
    assert mgr.restore(fresh, params_only=True).step == 4
    raw = mgr.restore_raw_params()
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, saved[k]) and torch.equal(raw[k], saved[k]), k
    assert os.path.exists(tmp_path / "ckpt" / "ckpt_4.pt")


def test_logger_writes_jsonl_meters_and_panels(tmp_path, capsys):
    """The port's Logger against the JAX package's on the same calls: the
    same JSON-lines records (but for the wall time), the same running
    means, and the same PNG panel bytes."""
    from real_robot_nerf_actor_tpu.utils.logger import Logger as JaxLogger
    from real_robot_nerf_actor_tpu_torch.utils.logger import Logger
    rng = np.random.default_rng(0)
    panel = [rng.uniform(0, 1, (4, 5, 3)), rng.uniform(-2, 3, (3, 2))]
    paths, recs, meters = [], [], []
    for cls, d in ((JaxLogger, tmp_path / "jax"), (Logger, tmp_path / "port")):
        log = cls(str(d), print_every=2)
        for step in (1, 2):
            log.log({"loss": 1.5 * step, "acc": 0.25}, step)
        paths.append(log.log_image_panel("views", panel, 2))
        meters.append({k: m.value() for k, m in log._meters.items()})
        log.close()
        recs.append([{k: v for k, v in json.loads(line).items() if k != "time"}
                     for line in (d / "metrics.jsonl").read_text().splitlines()])
    assert recs[0] == recs[1] and len(recs[1]) == 2
    assert meters[0] == meters[1] == {"train/loss": 2.25, "train/acc": 0.25}
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert capsys.readouterr().err.count("[train] step 2") == 2
