"""tools/train_rl.py, the port's counterpart of scripts/train_rl.py: SAC on
the port's MuJoCo `reach` in state observations trains a hundred steps on
the CPU (random seed steps, then one update a step from a uniform and from a
prioritized buffer, one eval), logs the script's Logger categories and
writes the JSON keys the JAX script writes (read from its source)."""
import ast
import json
import pathlib

import pytest

pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

from real_robot_nerf_actor_tpu_torch.tools import train_rl  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_out_keys():
    """The keys of the dict the JAX script json.dump-s to --out."""
    tree = ast.parse((REPO / "scripts" / "train_rl.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dump"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dump of a dict in scripts/train_rl.py")


@pytest.mark.parametrize("prioritized", [False, True])
def test_train_rl_cli_trains_and_writes_the_scripts_json(tmp_path, prioritized):
    out = tmp_path / "rl.json"
    argv = ["--task", "reach", "--steps", "101", "--seed-steps", "16", "--batch-size", "8",
            "--episode-length", "10", "--eval-every", "50", "--final-eval-episodes", "2",
            "--log-dir", str(tmp_path / "log"), "--out", str(out), "--device", "cpu"]
    result = train_rl.main(argv + (["--prioritized"] if prioritized else []))
    written = json.loads(out.read_text())
    assert set(written) == _jax_out_keys() == set(result)
    assert written["train_steps"] == 101 and written["final_eval_episodes"] == 2
    assert 0.0 <= written["final_success_rate"] <= 1.0
    records = [json.loads(line) for line in (tmp_path / "log" / "metrics.jsonl").open()]
    train = [r for r in records if r["category"] == "train"]
    assert {r["category"] for r in records} == {"train", "eval"}
    assert sum("episode_return" in r for r in train) == 10
    assert any("critic_loss" in r and "actor_loss" in r and "alpha" in r for r in train)
    assert sum("eval_success_rate" in r for r in records) == 2
