"""SAC on the MuJoCo xArm suite (the counterpart of scripts/train_rl.py, with
its flags, its Logger categories and its --out JSON keys): seed steps of
random actions, then one SAC update a step from a uniform or prioritized
buffer, a 5-episode eval every --eval-every steps, and optionally a final
success rate over fresh episodes.

    python -m real_robot_nerf_actor_tpu_torch.tools.train_rl --task reach \
        [--obs-mode state|image] [--steps 5000] [--out result.json] [--device cuda]

Needs `mujoco` and `gymnasium`. The agent runs on --device (the card unless
`--device cpu`); the env runs on the host.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="reach")
    ap.add_argument("--obs-mode", default="state", choices=["state", "image"])
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--seed-steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--episode-length", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--prioritized", action="store_true")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--final-eval-episodes", type=int, default=0,
                    help="after training, measure success over N fresh "
                         "episodes and write it to --out (the reference's "
                         "env-success evaluation protocol)")
    ap.add_argument("--out", default=None,
                    help="write {task, steps, final_success_rate, ...} JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from real_robot_nerf_actor_tpu_torch.envs import make_env
    from real_robot_nerf_actor_tpu_torch.rl import (
        PrioritizedReplayBuffer, ReplayBuffer, SACAgent, SACConfig)
    from real_robot_nerf_actor_tpu_torch.utils.logger import Logger

    env = make_env(task_name=args.task, obs_mode=args.obs_mode,
                   episode_length=args.episode_length)
    obs, _ = env.reset(seed=0)
    action_dim = int(np.prod(env.action_space.shape))
    agent = SACAgent(SACConfig(action_dim=action_dim, obs_type=args.obs_mode), obs,
                     device=args.device)
    buf_cls = PrioritizedReplayBuffer if args.prioritized else ReplayBuffer
    rb = buf_cls(100000, obs.shape, action_dim)
    logger = Logger(args.log_dir, print_every=100)

    ep_ret, ep = 0.0, 0
    for step in range(args.steps):
        a = (env.action_space.sample() if step < args.seed_steps
             else agent.sample_action(obs))
        nobs, r, term, trunc, info = env.step(a)
        rb.add(obs, a, r, nobs, term)
        ep_ret += r
        obs = nobs
        if term or trunc:
            logger.log({"episode_return": ep_ret,
                        "success": float(info.get("episode_success", 0))}, step)
            obs, _ = env.reset(seed=ep)
            ep += 1
            ep_ret = 0.0
        if step >= args.seed_steps:
            batch = rb.sample(args.batch_size)
            m = agent.update(batch)
            rb.update_priorities(batch["idx"], m.pop("td_abs"))
            if step % 100 == 0:
                logger.log(dict(m), step)
        if (step + 1) % args.eval_every == 0:
            succ = 0
            for e in range(5):
                o, _ = env.reset(seed=10000 + e)
                for _ in range(args.episode_length):
                    o, r, tm, tc, inf = env.step(agent.select_action(o))
                    if tm or tc:
                        break
                succ += float(inf.get("episode_success", 0))
            logger.log({"eval_success_rate": succ / 5}, step + 1, category="eval")
            obs, _ = env.reset(seed=ep)

    result = {}
    if args.final_eval_episodes > 0:
        succ, rets = 0.0, []
        for e in range(args.final_eval_episodes):
            o, _ = env.reset(seed=20000 + e)
            ret = 0.0
            for _ in range(args.episode_length):
                o, r, tm, tc, inf = env.step(agent.select_action(o))
                ret += r
                if tm or tc:
                    break
            succ += float(inf.get("episode_success", 0))
            rets.append(ret)
        rate = succ / args.final_eval_episodes
        print(f"[rl] final success over {args.final_eval_episodes} eps: {rate:.2f}")
        result = {"task": args.task, "algo": "sac", "obs_mode": args.obs_mode,
                  "train_steps": args.steps,
                  "final_eval_episodes": args.final_eval_episodes,
                  "final_success_rate": rate, "mean_return": float(np.mean(rets))}
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
    logger.close()
    return result


if __name__ == "__main__":
    main()
