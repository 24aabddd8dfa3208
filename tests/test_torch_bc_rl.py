"""Behaviour cloning, RL and stored episodes of the PyTorch port against the
JAX package, at a tiny size (ResNet-18 at 32 x 32, batch 2; heads 32
wide; DiffusionQL over 10 timesteps): the same weights (the JAX trainers'
variables, BatchNorm statistics and scales redrawn with numpy, through
convert.flax_to_state_dict), the same numpy inputs, and the JAX keys' draws
fed to the port (`t=`, `eps=`, `x=`, `noise=`, `draws=`).

Tolerances (fp32): losses 1e-5 relative; a first step's gradients within
1e-4 of each tensor's largest |g|; parameters after k Adam steps within
1e-6 relative plus 2e-5 lr a step (the optax-on-torch bound of
test_torch_trainer, for equal gradients), plus, for an entry whose gradient
is small against its tensor's largest, the move of Adam's normalised step
under that gradient tolerance (see _params_close); sampled indices, episode
files and dataset samples equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.data import demos as jdemos
from real_robot_nerf_actor_tpu.data import episodes as jep
from real_robot_nerf_actor_tpu.rl import diffusion_bc as jdbc
from real_robot_nerf_actor_tpu.rl import replay as jreplay
from real_robot_nerf_actor_tpu.rl import sac as jsac
from real_robot_nerf_actor_tpu.train import bc as jbc
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data import demos as tdemos
from real_robot_nerf_actor_tpu_torch.data import episodes as tep
from real_robot_nerf_actor_tpu_torch.rl import diffusion_bc as tdbc
from real_robot_nerf_actor_tpu_torch.rl import replay as treplay
from real_robot_nerf_actor_tpu_torch.rl import sac as tsac
from real_robot_nerf_actor_tpu_torch.train import bc as tbc
from test_torch_zoo import images, one_torch_thread, redraw_norms  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want, tol=1e-5):
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (got, want)


def _grads_close(named_grads, want: dict, msg=""):
    """Each gradient within 1e-4 of its tensor's largest |g| (a missing
    .grad counts as zeros)."""
    for n, w in want.items():
        g = named_grads.get(n)
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-30,
                                   err_msg=f"{msg} {n}")


def _params_close(named, want: dict, lr, steps, msg="", grads=None):
    """Within 1e-6 relative plus 2e-5 lr a step. With `grads` (the port's
    gradients by name, one per Adam step taken), an entry whose gradient is
    small against its tensor's largest |g| gets lr * min(2, 1e-4 max|g| /
    |g|) more a step: the two packages' gradients differ by rounding, within
    the gradient tolerance (1e-4 of the largest |g|), and Adam's normalised
    step of that entry moves with its relative gap (by at most 2: a step's
    magnitude is at most 1)."""
    for n, w in want.items():
        got = named[n].detach().numpy()
        atol = 2e-5 * lr * steps
        for g in (grads or {}).get(n, ()):
            atol = atol + lr * np.minimum(2.0, 1e-4 * np.abs(g).max()
                                          / np.maximum(np.abs(g), 1e-30))
        gap = np.abs(got - w) - atol - 1e-6 * np.abs(w)
        assert (gap <= 0).all(), (f"{msg} {n}: {int((gap > 0).sum())} of {gap.size} over, "
                                  f"worst by {gap.max()}")


def record_grads(optimizer, log: dict):
    """Wrap optimizer.step to append each parameter's gradient to log[name]
    before the step."""
    step = optimizer.step

    def recording():
        for n, p in zip(optimizer.names, optimizer.params):
            if p.grad is not None:
                log.setdefault(n, []).append(p.grad.numpy().copy())
        return step()
    optimizer.step = recording
    return log


def _sd(tree, prefix=""):
    return {prefix + k: v.numpy() for k, v in flax_to_state_dict(tree).items()}


def sampler_draws(key, b, a, n_t):
    """The JAX sampler's draws from `key`: the initial x and the per-step
    noise (n_t, b, a), noise[i] at t = n_t - 1 - i."""
    k_init, key = jax.random.split(key)
    x = jax.random.normal(k_init, (b, a))
    noise = []
    for _ in range(n_t):
        key, k_noise = jax.random.split(key)
        noise.append(jax.random.normal(k_noise, (b, a)))
    return np.asarray(x), np.asarray(jnp.stack(noise))


def update_draws(rng_key, b, shape, n_t):
    """DiffusionBC.update's (t, eps) from the agent's key, as it splits it."""
    _, k = jax.random.split(rng_key)
    k_t, k_eps = jax.random.split(k)
    return (np.asarray(jax.random.randint(k_t, (b,), 0, n_t)),
            np.asarray(jax.random.normal(k_eps, shape)))


# ------------------------------------------------------------------ BC
BC_LR = 1e-3


def _bc_kw(head, freeze, embedding="resnet18", batch_size=2):
    return dict(embedding=embedding, policy_head=head, freeze_encoder=freeze, hidden_dim=32,
                batch_size=batch_size, lr=BC_LR)


def _bc_pair(head, freeze, embedding="resnet18", obs_example=None, batch_size=2):
    kw = _bc_kw(head, freeze, embedding, batch_size)
    obs_example = images(n=1)[0] if obs_example is None else obs_example
    jtr = jbc.BCTrainer(jbc.BCConfig(**kw), obs_example, seed=0)
    if jtr.enc_vars:
        jtr.enc_vars = redraw_norms(_np(jtr.enc_vars), np.random.default_rng(3))
    ttr = tbc.BCTrainer(tbc.BCConfig(**kw), obs_example, seed=0, device="cpu")
    if ttr.encoder is not None:
        ttr.encoder.load_state_dict(flax_to_state_dict(jtr.enc_vars))
    if head == "diffusion":
        ttr.policy.net.load_state_dict(flax_to_state_dict({"params": jtr.policy.params}))
    else:
        ttr.policy.load_state_dict(flax_to_state_dict({"params": jtr.pol_params}))
    return jtr, ttr


@functools.lru_cache(maxsize=None)
def _jax_bc(head, freeze, steps=3):
    """The JAX trainer's run, once a process: its initial variables (norms
    redrawn), each step's batch, draws and loss, the first step's
    gradients (MLP head), and the final variables."""
    jtr = jbc.BCTrainer(jbc.BCConfig(**_bc_kw(head, freeze)), images(n=1)[0], seed=0)
    jtr.enc_vars = redraw_norms(_np(jtr.enc_vars), np.random.default_rng(3))

    def head_params():
        return _np(jtr.policy.params if head == "diffusion" else jtr.pol_params)

    init = (jtr.enc_vars, head_params())
    rng = np.random.default_rng(11)
    steps_out, want_g = [], None
    for k in range(steps):
        obs = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        act = rng.uniform(-1, 1, (2, 4)).astype(np.float32)
        draws = {}
        if head == "diffusion":
            draws = dict(zip(("t", "eps"), update_draws(jtr.policy._rng, 2, act.shape, 100)))
        elif k == 0:    # the JAX step's gradients, from the same loss
            def loss_fn(pp, ev):
                feat = jtr.embedding(ev, jnp.asarray(obs))
                if freeze:
                    feat = jax.lax.stop_gradient(feat)
                return jnp.mean((jtr.policy.apply({"params": pp}, feat) - act) ** 2)
            gp, ge = jax.grad(loss_fn, argnums=(0, 1))(jtr.pol_params, jtr.enc_vars)
            want_g = _sd({"params": gp}, "policy.")
            if not freeze:
                want_g.update(_sd(_np(ge), "encoder."))
        steps_out.append((obs, act, draws, jtr.update(obs, act)))
    return init, steps_out, want_g, (_np(jtr.enc_vars), head_params())


def _run_bc(head, freeze):
    (enc0, head0), steps_out, want_g, (enc1, head1) = _jax_bc(head, freeze)
    ttr = tbc.BCTrainer(tbc.BCConfig(**_bc_kw(head, freeze)), images(n=1)[0], seed=0,
                        device="cpu")
    ttr.encoder.load_state_dict(flax_to_state_dict(enc0))
    net = ttr.policy.net if head == "diffusion" else ttr.policy
    net.load_state_dict(flax_to_state_dict({"params": head0}))
    stats0 = {n: b.clone() for n, b in ttr.encoder.named_buffers()}
    grads = record_grads(ttr.policy.optimizer if head == "diffusion" else ttr.optimizer, {})
    for k, (obs, act, draws, loss) in enumerate(steps_out):
        _rel(ttr.update(obs, act, **draws), loss)
        if k == 0 and want_g is not None:
            _grads_close({n: p.grad for n, p in zip(ttr.optimizer.names, ttr.optimizer.params)},
                         want_g, "step 0")
    steps = len(steps_out)
    if head == "diffusion":
        _params_close(dict(net.named_parameters()), _sd({"params": head1}), BC_LR, steps,
                      "noise model", grads)
        return
    named = dict(zip(ttr.optimizer.names, ttr.optimizer.params))
    _params_close(named, _sd({"params": head1}, "policy."), BC_LR, steps, "head", grads)
    enc = {f"encoder.{n}": v for n, v in ttr.encoder.state_dict().items()}
    _params_close(enc, _sd(enc1, "encoder."), BC_LR, steps, "encoder", grads)
    moved = any((stats0[n] != b).any() for n, b in ttr.encoder.named_buffers())
    assert moved != freeze


@pytest.mark.parametrize("head,freeze", [("mlp", True), ("mlp", False), ("diffusion", False)])
def test_bc_updates_match_jax(head, freeze):
    """Three BC updates on a ResNet-18 zoo encoder with BatchNorm: the MLP
    head frozen (head only) and fine-tuned (encoder, its BatchNorm running
    statistics included, stepped by Adam as JAX steps its batch_stats), and
    the diffusion head on frozen features with JAX's t / eps."""
    _run_bc(head, freeze)


def test_bc_finetune_check_sees_frozen_statistics(monkeypatch):
    """Left frozen, the running statistics part from JAX's after the first
    update, and the fine-tune check above fails."""
    monkeypatch.setattr(tbc, "train_statistics_", lambda module: [])
    with pytest.raises(AssertionError):
        _run_bc("mlp", False)


def _trajectories(n_traj=2, steps=14, obs="state", seed=0):
    """Trajectories with a gripper flip and a stop (keyframes of both
    rules); obs state vectors, images, or point clouds of varying size."""
    rng = np.random.default_rng(seed)
    out = []
    for ti in range(n_traj):
        ee = np.cumsum(rng.normal(0, 0.01, (steps, 3)), axis=0) + 0.3
        ee[8] = ee[7]                                          # a stop
        grip = np.where(np.arange(steps) < 5 + ti, 1.0, 0.0)   # a flip
        if obs == "state":
            o = list(rng.standard_normal((steps, 7)).astype(np.float32))
        elif obs == "image":
            o = list(rng.uniform(0, 1, (steps, 8, 8, 3)).astype(np.float32))
        else:
            o = [{"points": rng.uniform(-0.5, 0.5, (150 + 10 * i + ti, 3)).astype(np.float32),
                  "colors": rng.uniform(0, 1, (150 + 10 * i + ti, 3)).astype(np.float32)}
                 for i in range(steps)]
        out.append(dict(observations=o, actions=list(rng.uniform(-1, 1, (steps, 4))
                                                     .astype(np.float32)),
                        rewards=list(rng.standard_normal(steps)), gripper_open=list(grip),
                        ee_positions=list(ee), success=bool(ti % 2)))
    return ([jdemos.Trajectory(**d) for d in out], [tdemos.Trajectory(**d) for d in out])


@pytest.mark.parametrize("keyframe_mode", [False, True])
def test_bc_datasets_match_jax(keyframe_mode):
    """dataset_from_trajectories (keyframe mode: the motion toward the next
    keyframe and its gripper), KeyframeBuffer's discovery and
    simple_motion_planning equal to JAX's."""
    jt, tt = _trajectories()
    kw = dict(embedding="state", obs_mode="state", keyframe_mode=keyframe_mode, hidden_dim=8)
    jo, ja = jbc.BCTrainer(jbc.BCConfig(**kw), jt[0].observations[0]).dataset_from_trajectories(jt)
    to, ta = tbc.BCTrainer(tbc.BCConfig(**kw), tt[0].observations[0],
                           device="cpu").dataset_from_trajectories(tt)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(np.stack(to), np.stack(jo))
    for a, b in zip(jt, tt):
        assert tdemos.KeyframeBuffer()._discover(b) == jdemos.KeyframeBuffer()._discover(a)
    start, goal = np.zeros(3), np.asarray([0.3, -0.2, 0.5])
    np.testing.assert_array_equal(tdemos.simple_motion_planning(start, goal, 4),
                                  jdemos.simple_motion_planning(start, goal, 4))


class ReachEnv:
    """A gym-style env for `evaluate`: the state is (position, goal, 1),
    step moves the position by 0.1 a[:3]; success within 0.2 of the goal.
    Records the actions it is given."""

    def __init__(self):
        self.actions = []

    def _obs(self):
        return np.concatenate([self.pos, self.goal, [1.0]]).astype(np.float32)

    def reset(self, seed=None):
        rng = np.random.default_rng(seed)
        self.pos, self.goal, self.t = rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3), 0
        return self._obs(), {}

    def step(self, a):
        self.actions.append(np.asarray(a, np.float64))
        self.pos = self.pos + 0.1 * np.asarray(a[:3], np.float64)
        self.t += 1
        success = bool(np.linalg.norm(self.pos - self.goal) < 0.2)
        return self._obs(), float(success), False, self.t >= 12, {"success": success}


@pytest.mark.parametrize("head", ["mlp", "diffusion"])
def test_bc_fit_and_evaluate_match_jax(head):
    """fit (two epochs in default_rng order, batches of 4) gives JAX's
    losses; evaluate on a duck-typed env gives JAX's success rate over the
    same actions (for the diffusion head, the sampler's draws fed)."""
    jt, tt = _trajectories(n_traj=3, steps=10)
    jtr, ttr = _bc_pair(head, False, embedding="state", obs_example=jt[0].observations[0],
                        batch_size=4)
    envs = (ReachEnv(), ReachEnv())
    if head == "mlp":
        for lj, lt in zip(jtr.fit(jt, epochs=2), ttr.fit(tt, epochs=2)):
            _rel(lt, lj)
        rates = (jtr.evaluate(envs[0], n_episodes=3, max_steps=10),
                 ttr.evaluate(envs[1], n_episodes=3, max_steps=10))
    else:
        # the key of each JAX sample, then its draws fed to the port's
        keys, sample = [], jtr.policy.sample_action

        def record(obs):
            keys.append(jax.random.split(jtr.policy._rng)[1])
            return sample(obs)
        jtr.policy.sample_action = record
        rates = [jtr.evaluate(envs[0], n_episodes=2, max_steps=4)]
        draws, act = iter(keys), ttr.act

        def fed(obs):
            x, noise = sampler_draws(next(draws), 1, 4, 100)
            return act(obs, x=x, noise=noise)
        ttr.act = fed
        rates.append(ttr.evaluate(envs[1], n_episodes=2, max_steps=4))
    assert rates[0] == rates[1]
    assert len(envs[0].actions) == len(envs[1].actions) > 0
    np.testing.assert_allclose(np.stack(envs[1].actions), np.stack(envs[0].actions),
                               rtol=0, atol=1e-5)


def test_bc_pointcloud_observations():
    """Point-cloud BC: _stack_obs cuts every cloud to the smallest one's
    size (at most 4096), as JAX's; a pointnet2 BC update on the stacked
    clouds, its BatchNorm statistics trained (the encoder's parity is
    test_torch_zoo's)."""
    rng = np.random.default_rng(2)
    clouds = [{"points": rng.uniform(0, 1, (n, 3)).astype(np.float32),
               "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32)} for n in (520, 600)]
    jb, tb = jbc._stack_obs(clouds), tbc._stack_obs(clouds)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    big = [{"points": np.zeros((5000, 3), np.float32)}] * 2
    assert tbc._stack_obs(big)["points"].shape == (2, 4096, 3)
    pts = np.concatenate([tb["points"], tb["colors"]], -1)
    tr = tbc.BCTrainer(tbc.BCConfig(**_bc_kw("mlp", False, "pointnet2")), pts[0], device="cpu")
    stats = tr.encoder.sa1.bn0.running_mean.detach().clone()
    assert np.isfinite(tr.update(pts, rng.uniform(-1, 1, (2, 4))))
    assert (tr.encoder.sa1.bn0.running_mean != stats).any()


# ------------------------------------------------------------- diffusion
def test_diffusion_sampler_matches_jax():
    """The betas, alpha_bar (an fp32 cumulative product) and a 100-step
    sample of DiffusionBC with the JAX sampler's draws fed."""
    cfg = dict(obs_dim=5, action_dim=3, hidden_dim=16)
    jag = jdbc.DiffusionBC(jdbc.DiffusionBCConfig(**cfg), seed=0)
    tag = tdbc.DiffusionBC(tdbc.DiffusionBCConfig(**cfg), seed=0, device="cpu")
    tag.net.load_state_dict(flax_to_state_dict({"params": jag.params}))
    np.testing.assert_allclose(tag.alpha_bar.numpy(), np.asarray(jag.alpha_bar), rtol=1e-6)
    for s in ("linear", "vp"):
        np.testing.assert_array_equal(tdbc.make_betas(s, 100), jdbc.make_betas(s, 100))
    obs = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    _, k = jax.random.split(jag._rng)
    x, noise = sampler_draws(k, 4, 3, 100)
    want = jag.sample_action(obs)
    got = tag.sample_action(obs, x=x, noise=noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_diffusion_ql_update_matches_jax():
    """Two DiffusionQL updates (the first with the EMA step) with JAX's
    draws: the four losses, the actor, the critic, its target, the EMA."""
    cfg = dict(obs_dim=5, action_dim=3, hidden_dim=16, n_timesteps=10, lr=1e-3,
               critic_lr=1e-3, update_ema_every=2, tau=0.1, ema_decay=0.9)
    jag = jdbc.DiffusionQL(jdbc.DiffusionQLConfig(**cfg), seed=0)
    tag = tdbc.DiffusionQL(tdbc.DiffusionQLConfig(**cfg), seed=0, device="cpu")
    for m, p in ((tag.net, jag.params), (tag.ema, jag.ema_params), (tag.critic, jag.critic_params),
                 (tag.critic_target, jag.critic_target)):
        m.load_state_dict(flax_to_state_dict({"params": p}))
    grads = record_grads(tag.critic_optimizer, record_grads(tag.optimizer, {}))
    rng = np.random.default_rng(5)
    b, n_t = 6, cfg["n_timesteps"]
    for step in range(2):
        obs, nxt = (rng.standard_normal((b, 5)).astype(np.float32) for _ in range(2))
        act = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
        rew = rng.standard_normal(b).astype(np.float32)
        nd = (rng.uniform(size=b) > 0.2).astype(np.float32)
        _, k = jax.random.split(jag._rng)
        k_t, k_eps, k_next, k_new, k_coin = jax.random.split(k, 5)
        d = {"t": np.asarray(jax.random.randint(k_t, (b,), 0, n_t)),
             "eps": np.asarray(jax.random.normal(k_eps, (b, 3))),
             "coin": bool(jax.random.bernoulli(k_coin))}
        d["next_x"], d["next_noise"] = sampler_draws(k_next, b, 3, n_t)
        d["new_x"], d["new_noise"] = sampler_draws(k_new, b, 3, n_t)
        mj = jag.update_ql(obs, act, nxt, rew, nd)
        mt = tag.update_ql(obs, act, nxt, rew, nd, draws=d)
        for key in mj:
            _rel(mt[key], mj[key], 1e-4)
    for m, p, name in ((tag.net, jag.params, "actor"), (tag.ema, jag.ema_params, "ema"),
                       (tag.critic, jag.critic_params, "critic"),
                       (tag.critic_target, jag.critic_target, "target")):
        _params_close(dict(m.named_parameters()), _sd({"params": p}), 1e-3, 2, name, grads)


# ------------------------------------------------------------------- SAC
SAC_LR = 1e-3


def _sac_pair(obs_type):
    cfg = dict(action_dim=3, obs_type=obs_type, hidden_dim=32, encoder_feature_dim=12,
               actor_lr=SAC_LR, critic_lr=SAC_LR, alpha_lr=SAC_LR)
    example = (np.zeros((16, 16, 3), np.float32) if obs_type == "image"
               else np.zeros(6, np.float32))
    jag = jsac.SACAgent(jsac.SACConfig(**cfg), example, seed=0)
    tag = tsac.SACAgent(tsac.SACConfig(**cfg), example, seed=0, device="cpu")
    tag.net.load_state_dict(flax_to_state_dict({"params": jag.params}))
    tag.target.load_state_dict(flax_to_state_dict({"params": jag.target_params}))
    return jag, tag, example.shape


def _run_sac(obs_type, steps=3):
    jag, tag, shape = _sac_pair(obs_type)
    grads = record_grads(tag.critic_opt, {})
    record_grads(tag.actor_opt, grads)
    rng = np.random.default_rng(9)
    b = 8
    for step in range(steps):
        batch = {"obs": rng.uniform(0, 1, (b, *shape)).astype(np.float32),
                 "next_obs": rng.uniform(0, 1, (b, *shape)).astype(np.float32),
                 "action": rng.uniform(-1, 1, (b, 3)).astype(np.float32),
                 "reward": rng.standard_normal(b).astype(np.float32),
                 "done": (rng.uniform(size=b) < 0.2).astype(np.float32),
                 "weights": rng.uniform(0.5, 1.0, b).astype(np.float32),
                 "idx": np.arange(b)}
        _, k1, k2 = jax.random.split(jag._rng, 3)
        eps = {"critic": np.asarray(jax.random.normal(k1, (b, 3))),
               "actor": np.asarray(jax.random.normal(k2, (b, 3)))}
        mj, mt = jag.update(batch), tag.update(batch, eps=eps)
        assert mt.keys() == mj.keys()
        for key in ("critic_loss", "actor_loss", "alpha"):
            if key in mj:
                _rel(mt[key], mj[key], 1e-4)
        np.testing.assert_allclose(mt["td_abs"], mj["td_abs"], rtol=1e-4, atol=1e-5)
    _params_close(dict(tag.net.named_parameters()), _sd({"params": jag.params}), SAC_LR, steps,
                  "net", grads)
    _params_close(dict(tag.target.named_parameters()), _sd({"params": jag.target_params}),
                  SAC_LR, steps, "target", grads)
    np.testing.assert_allclose(tag.log_alpha.item(), float(jag.log_alpha), rtol=1e-6,
                               atol=2e-5 * SAC_LR * steps)


@pytest.mark.parametrize("obs_type", ["state", "image"])
def test_sac_updates_match_jax(obs_type):
    """Three SAC updates with JAX's squash draws: critic steps every update,
    actor and temperature steps at updates 0 and 2, soft targets at 0 and 2;
    losses, alpha, |td|, every weight, the targets and log_alpha."""
    _run_sac(obs_type)


def test_sac_check_sees_actor_gradient_in_the_encoder(monkeypatch):
    """The actor's loss with the encoder's features not detached: its Adam
    then moves the encoder, and the check above fails."""
    def leaky(self, obs, eps):
        mu, log_std = self.net.actor(self.net.encode(obs))
        a, logp = tsac._squash(mu, log_std, eps)
        with tsac._no_grad_into(self.net.critic, self.net.encoder):
            q1, q2 = self.net.q(obs, a)
        return (torch.exp(self.log_alpha.detach()) * logp - torch.minimum(q1, q2)).mean(), logp
    monkeypatch.setattr(tsac.SACAgent, "actor_loss", leaky)
    with pytest.raises(AssertionError):
        _run_sac("image", steps=1)


def test_sac_acting():
    """select_action is tanh(mu); sample_action squashes with the eps given."""
    jag, tag, shape = _sac_pair("state")
    obs = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    mu, log_std = jag.net.apply({"params": jag.params}, jnp.asarray(obs)[None],
                                method=jag.net.pi)
    np.testing.assert_allclose(tag.select_action(obs), np.tanh(np.asarray(mu))[0], atol=1e-6)
    eps = np.random.default_rng(5).standard_normal((1, 3)).astype(np.float32)
    want = np.tanh(np.asarray(mu) + eps * np.exp(np.asarray(log_std)))[0]
    np.testing.assert_allclose(tag.sample_action(obs, eps=eps), want, atol=1e-6)


# ---------------------------------------------------------------- replay
@pytest.mark.parametrize("kind", ["ReplayBuffer", "PrioritizedReplayBuffer"])
def test_replay_buffers_sample_like_jax(kind):
    """The same seed samples the same indices and weights, across the ring's
    wrap and priority updates."""
    bufs = [getattr(m, kind)(40, (5,), 2, seed=3) for m in (jreplay, treplay)]
    rng = np.random.default_rng(0)
    for i in range(55):
        tr = (rng.standard_normal(5), rng.standard_normal(2), rng.standard_normal(),
              rng.standard_normal(5), i % 7 == 0)
        for buf in bufs:
            buf.add(*tr)
    for _ in range(4):
        j, t_ = (buf.sample(16) for buf in bufs)
        assert j.keys() == t_.keys()
        for k in j:
            np.testing.assert_array_equal(t_[k], j[k], err_msg=k)
        pri = rng.uniform(0, 3, 16)
        for buf in bufs:
            buf.update_priorities(j["idx"], pri)
    assert len(bufs[0]) == len(bufs[1]) == 40


# -------------------------------------------------------------- episodes
BOUNDS = (-0.6, -0.6, -0.05, 0.6, 0.6, 0.6)


@pytest.mark.parametrize("obs", ["pointcloud", "image"])
def test_episode_files_match_jax(tmp_path, obs):
    """save_trajectory writes JAX's file key for key; each package loads the
    other's file."""
    jt, tt = _trajectories(obs=obs)
    jep.save_trajectory(str(tmp_path / "j.npz"), jt[0])
    tep.save_trajectory(str(tmp_path / "t.npz"), tt[0])
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    a, b = tep.load_trajectory(str(tmp_path / "j.npz")), jep.load_trajectory(str(tmp_path / "t.npz"))
    assert a.success == b.success and len(a.observations) == len(b.observations)
    for oa, ob in zip(a.observations, b.observations):
        if isinstance(oa, dict):
            for k in oa:
                np.testing.assert_array_equal(oa[k], ob[k])
        else:
            np.testing.assert_array_equal(oa, ob)


def test_episode_dataset_matches_jax(tmp_path):
    """EpisodeDataset over a directory of episodes: the keyframe pairs, every
    get() and a batch equal to JAX's; the batch feeds a tiny PerAct step."""
    jt, tt = _trajectories(obs="pointcloud")
    for i, tr in enumerate(tt):
        tep.save_trajectory(str(tmp_path / f"ep{i}.npz"), tr)
    kw = dict(coord_bounds=BOUNDS, voxel_size=10, max_num_coords=200, lang_shape=(4, 16))
    jds, tds = jep.EpisodeDataset(str(tmp_path), **kw), tep.EpisodeDataset(str(tmp_path), **kw)
    assert tds.samples == jds.samples and len(tds) > 2
    for i in range(len(tds)):
        g, w = tds.get(i), jds.get(i)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    tb = next(tds.batches(batch_size=3, seed=1, device="cpu"))
    jb = next(jds.batches(batch_size=3, seed=1))
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)

    from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
    cfg = PerActConfig(
        model=PerceiverConfig(depth=1, voxel_size=10, num_latents=16, latent_dim=32,
                              im_channels=8, cross_dim_head=8, latent_dim_head=8,
                              latent_heads=2, voxel_patch_size=5, final_dim=8,
                              lang_emb_dim=16, lang_max_seq_len=4),
        voxelizer=VoxelizerSpec(voxel_size=10, feature_size=3, max_num_coords=200),
        coord_bounds=BOUNDS)
    tr = PerActTrainer(cfg, device="cpu")
    _, m = tr.train_step(tr.init_state(torch.Generator().manual_seed(0)), tb)
    assert np.isfinite(m["loss"].item())
