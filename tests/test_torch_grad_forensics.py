"""tools/grad_forensics.py, the port's counterpart of
scripts/grad_forensics.py, at the tiny joint config of the parity tests
(10^3 voxels: the UNet's upsample needs V = 2 x patch 5; depth 1, 16 x 32
latents, 8 x 8 views, 8 rays of 6 + 4 samples, field 8 -> 2 x 16) on a
1-kitchen x 1-task x 2-demo dataset the port writes:

  - replay is the run: `train/nerfact.main --multi-root --ckpt-dir` trains
    6 steps with a checkpoint at step 3 and logs every step; replay from
    that checkpoint gives the run's logged metrics of steps 4-6 bit for bit
    (the generator fast-forwarded by DrawTape, the data by its iterator);
  - dissect against the JAX script's dissect (loaded through importlib) on
    the same parameters (numpy draws in the flax tree, converted), batch
    and draws (the JAX stash's key, fed to the port as train_step takes
    them): the four terms within 1e-5 relative, each term's gradients
    within 1e-4 of each tensor's largest |g| (the joint step's bounds;
    trans_decoder.bias, which no loss moves beyond rounding, within 1e-5 of
    the largest gradient);
  - the two planted faults (a field weight set to inf; a latent
    self-attention weight set to inf), each in a copy of the checkpoint or
    stash: replay stashes the first events and no others, the sets of
    non-finite leaves of every term equal JAX's under convert's name map,
    the term's own graph alone localizes fault 1 to loss_render, probe's
    first row is the faulty block's and mint names its segment.
"""
import argparse
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu_torch.convert import joint_to_state_dict
from real_robot_nerf_actor_tpu_torch.tools import grad_forensics as gf

REPO = pathlib.Path(__file__).resolve().parent.parent
BOUNDS = [-0.1, -0.3, -0.2, 0.8, 0.7, 0.7]
CFG = {"peract": {"model": dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32,
                                im_channels=8, cross_dim_head=8, latent_dim_head=8,
                                latent_heads=2, voxel_patch_size=5, final_dim=8,
                                num_rotation_classes=72, input_encoder="unet",
                                return_voxel_feat=True),
                  "voxelizer": dict(voxel_size=10, feature_size=3, max_num_coords=512),
                  "coord_bounds": BOUNDS,
                  "train": dict(num_steps=6, log_every=1, ckpt_every=3, eval_every=10 ** 9,
                                prefetch=0)},
       "renderer": dict(image_width=8, image_height=8, n_coarse=6, n_fine=4, n_fine_depth=2,
                        ray_chunk_size=8,
                        field=dict(d_latent=8, d_embed=4, d_hidden=16, n_blocks=2,
                                   combine_layer=1, coord_bounds=BOUNDS))}
FIELD_FAULT = ("nerf.mlp_coarse.Dense_0.weight", (0, 0), ("nerf", "mlp_coarse", "Dense_0",
                                                          "kernel"), (0, 0))
# no gradient beyond rounding in either package (the softmax CE does not see
# a shift of every trans logit): held to 1e-5 of the largest gradient, as
# test_torch_train_nerfact holds it
INVARIANT = "policy.trans_decoder.bias"
ATTN_FAULT = ("policy.self_attn_0.MHAttention_0.to_out.weight", (0, 0),
              ("policy", "self_attn_0", "MHAttention_0", "to_out", "kernel"), (0, 0))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The dataset, the config file, and a 6-step run with its log. One
    torch thread for the module: the replay equals the run bit for bit on
    the same thread count (the sums' order)."""
    from real_robot_nerf_actor_tpu_torch.data.kitchen import write_multi_kitchen_dataset
    from real_robot_nerf_actor_tpu_torch.train import nerfact
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("gradf")
    write_multi_kitchen_dataset(str(d / "data"), n_kitchens=1, n_tasks=1, n_demos=2,
                                device="cpu", image_hw=(8, 8), d_embed=4, n_points=600,
                                focal=8.0)
    (d / "cfg.json").write_text(json.dumps(CFG))
    nerfact.main(["--config", str(d / "cfg.json"), "--multi-root", str(d / "data"),
                  "--ckpt-dir", str(d / "ckpt"), "--log-dir", str(d / "log"), "--device", "cpu"])
    log = [json.loads(line) for line in (d / "log" / "metrics.jsonl").open()]
    yield d, {r["step"]: r for r in log if r["category"] == "train"}
    torch.set_num_threads(threads)


def _base(d):
    return ["--config", str(d / "cfg.json"), "--multi-root", str(d / "data"), "--device", "cpu"]


def test_replay_is_the_run(run):
    d, logged = run
    rec = gf.main(["--mode", "replay", "--ckpt-dir", str(d / "ckpt"), "--from-step", "3",
                   "--replay-steps", "3", "--out", str(d / "replay")] + _base(d))
    assert rec["from_step"] == 3 and rec["events"] == [] and rec["stashes"] == []
    assert [m["step"] for m in rec["metrics"]] == [4, 5, 6]
    for m in rec["metrics"]:
        want = logged[m["step"]]
        keys = set(m) - {"step"}
        assert keys <= set(want) and "loss_total" in keys
        assert all(m[k] == want[k] for k in keys), m["step"]
    assert json.loads((d / "replay" / "events.json").read_text())["metrics"] == rec["metrics"]


def test_replay_refuses_a_step_that_draws_otherwise(run, monkeypatch):
    """The fast-forward is checked: a step drawing one more value than the
    recorded one stops the replay."""
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer
    d, _ = run
    step, calls = NerfActTrainer.train_step, []

    def drifting(self, state, batch, generator=None, **kw):
        calls.append(1)
        if len(calls) > 1:
            torch.rand(1, generator=generator)
        return step(self, state, batch, generator, **kw)

    monkeypatch.setattr(NerfActTrainer, "train_step", drifting)
    with pytest.raises(RuntimeError, match="fast-forward"):
        gf.main(["--mode", "replay", "--ckpt-dir", str(d / "ckpt"), "--from-step", "3",
                 "--replay-steps", "1", "--out", str(d / "drift")] + _base(d))


# ---------------------------------------------------------------- against JAX
def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_grad_forensics",
                                                  REPO / "scripts" / "grad_forensics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_draws(key, rc, b):
    """The JAX step's draws for `key` as its train_step and rendering_loss
    split it, in the port's train_step arguments."""
    import jax
    k_aug, k_render = jax.random.split(key)
    aug = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))(
        jax.random.split(k_aug, b))
    k_sel, k_r = jax.random.split(k_render)
    ray_idx = jax.random.randint(k_sel, (rc["ray_chunk_size"],), 0,
                                 rc["image_height"] * rc["image_width"])
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(k_r, 5)
    k_u, k_j = jax.random.split(k_fine)
    r, nf = rc["ray_chunk_size"], rc["n_fine"] - rc["n_fine_depth"]
    d = {"coarse_u": jax.random.uniform(k_coarse, (r, rc["n_coarse"])),
         "fine_u": jax.random.uniform(k_u, (r, nf)),
         "fine_jitter": jax.random.uniform(k_j, (r, nf)),
         "fine_depth_eps": jax.random.normal(k_fdepth, (r, rc["n_fine_depth"]))}
    t = torch.from_numpy
    return dict(draws=t(np.array(aug)), ray_idx=t(np.array(ray_idx)),
                render_draws={k: t(np.array(v)) for k, v in d.items()})


@pytest.fixture(scope="module")
def pair(run):
    """(write(fault, tag) -> (port stash, JAX stash), the JAX tool, draws):
    one parameter draw (numpy, in the flax tree; the UNet head at 0.05 as
    the joint-step parity tests draw it) and one batch for both packages."""
    import jax

    from test_torch_train_nerfact import _numpy_state
    d, _ = run
    jgf = _jax_tool()
    args = argparse.Namespace(config=str(d / "cfg.json"), override=[],
                              multi_root=str(d / "data"), exclude_demos="")
    jtr, entries = jgf.build(args)
    params, extra = _numpy_state(jtr)
    params = jax.tree_util.tree_map(np.asarray, params)
    batch = {k: np.asarray(v) for k, v in next(jtr.multi_replay_data(entries, 1)).items()}
    key = jax.random.key(7)
    draws = _jax_draws(key, CFG["renderer"], 1)

    def write(fault, tag):
        p = jax.tree_util.tree_map(np.array, params)
        if fault is not None:
            node = p
            for k in fault[2][:-1]:
                node = node[k]
            node[fault[2][-1]][fault[3]] = np.inf
        jpath, tpath = d / f"jax_{tag}.npz", d / f"port_{tag}.npz"
        payload = {f"batch/{k}": v for k, v in batch.items()}
        payload.update({f"params/{k}": np.asarray(v) for k, v in jgf.flatten(p).items()})
        np.savez(jpath, **payload, rng_key_data=np.asarray(jax.random.key_data(key)),
                 step=np.asarray(3))
        sd = joint_to_state_dict(p, jax.tree_util.tree_map(np.asarray, extra))
        if fault is not None:
            assert torch.isinf(sd[fault[0]][fault[1]])
        payload = {f"batch/{k}": v for k, v in batch.items()}
        payload.update({f"module/{k}": v.numpy() for k, v in sd.items()})
        np.savez(tpath, **payload, generator_state=torch.Generator().get_state().numpy(),
                 step=np.asarray(3))
        return tpath, jpath

    return write, jgf, args, draws


def _jax_dissect(jgf, args, jpath):
    """The JAX script's dissect report and its per-term gradient trees
    (the trees its report flattens, in TERMS order)."""
    trees, flatten = [], jgf.flatten
    jgf.flatten = lambda tree, prefix="": (trees.append(tree), flatten(tree, prefix))[1]
    try:
        jgf.dissect(argparse.Namespace(**vars(args), stash=str(jpath)))
    finally:
        jgf.flatten = flatten
    report = json.loads(pathlib.Path(str(jpath).replace(".npz", "_dissect.json")).read_text())
    grads = [t for t in trees if isinstance(t, dict) and "policy" in t][-len(gf.TERMS):]
    return report, grads


def _port_names(jax_rows, like):
    """JAX's non-finite leaf names in the port's state_dict names: a tree
    of NaN where JAX's leaf is non-finite, zeros elsewhere, converted."""
    import jax
    bad = {r[0] for r in jax_rows}
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(np.shape(a), np.nan if "/".join(
            str(getattr(k, "key", k)) for k in path) in bad else 0.0, np.float32), like)
    return {n for n, v in joint_to_state_dict(tree).items() if torch.isnan(v).any()}


def test_dissect_matches_jax(run, pair):
    import jax
    write, jgf, args, draws = pair
    d, _ = run
    tpath, jpath = write(None, "clean")
    want, jgrads = _jax_dissect(jgf, args, jpath)
    got = gf.dissect(argparse.Namespace(**vars(gf_args(d)), stash=str(tpath)), draws=draws,
                     keep_grads=True)
    assert want["nonfinite"] == {} and got["nonfinite"] == {}
    for t in gf.TERMS:
        np.testing.assert_allclose(got["terms"][t], want["terms"][t], rtol=1e-5, err_msg=t)
    np.testing.assert_allclose(got["probes"], want["probes"], rtol=1e-5)
    assert len(jgrads) == len(gf.TERMS)
    for t, tree in zip(gf.TERMS, jgrads):
        jg = joint_to_state_dict(jax.device_get(tree))
        tg = got["grads"][t]
        assert set(jg) == set(tg), t
        top = max(w.abs().max().item() for w in jg.values())
        for n, w in jg.items():
            g = tg[n] if tg[n] is not None else torch.zeros_like(w)
            if n == INVARIANT:
                assert max(w.abs().max().item(), g.abs().max().item()) <= 1e-5 * top + 1e-30
                continue
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max().item() + 1e-30,
                                       msg=lambda m: f"{t} {n}: {m}")
        if t in ("loss_trans", "loss_render"):
            assert max(w.abs().max().item() for w in jg.values()) > 0, t


def gf_args(d):
    return argparse.Namespace(config=str(d / "cfg.json"), override=[], multi_root=str(d / "data"),
                              exclude_demos="", device="cpu")


@pytest.mark.parametrize("fault", [FIELD_FAULT, ATTN_FAULT], ids=["field_inf", "attention_inf"])
def test_planted_faults_are_located_as_jax_locates_them(run, pair, fault):
    import jax
    write, jgf, args, draws = pair
    d, _ = run
    tag = fault[0].split(".")[1]
    tpath, jpath = write(fault, tag)
    want, _ = _jax_dissect(jgf, args, jpath)
    got = gf.dissect(argparse.Namespace(**vars(gf_args(d)), stash=str(tpath)), draws=draws)
    template = jax.tree_util.tree_map(np.asarray, jgf.build(args)[0].init_state(
        jax.random.key(0)).params)
    assert set(got["nonfinite"]) == set(want["nonfinite"]) == set(gf.TERMS)
    for t in gf.TERMS:
        assert {r[0] for r in got["nonfinite"][t]} == _port_names(want["nonfinite"][t],
                                                                   template), t
    for t, v in got["terms"].items():
        assert np.isfinite(v) == np.isfinite(want["terms"][t]), t
    ns = argparse.Namespace(**vars(gf_args(d)), stash=str(tpath))
    if fault is FIELD_FAULT:
        # the term's own graph: only the render term is non-finite, and it
        # reaches the field and the encoder that makes d0
        assert set(got["nonfinite_alone"]) == {"loss_render"}
        names = {r[0] for r in got["nonfinite_alone"]["loss_render"]}
        assert fault[0] in names and any(n.startswith("policy.encoder_3d") for n in names)
        assert all(r["bad"] == 0 for r in gf.probe(ns))
        assert gf.mint(ns)["first_nonfinite"] is None
    else:
        rows = gf.probe(ns)
        assert rows[0]["bad"] > 0 and rows[0]["name"].startswith("self_attn_0")
        assert all(r["bad"] == 0 for r in rows if r["name"].startswith(("encoder_3d", "cross_")))
        assert gf.mint(ns)["first_nonfinite"] == "self_attn_0(x)"


def test_replay_stashes_the_first_events_of_a_planted_fault(run):
    """Fault 1 planted in a copy of the step-3 checkpoint: every replayed
    step is an event, the first --max-stash are stashed, and a stash loads
    back the faulty weight, the batch and the step's generator state."""
    d, _ = run
    ck = torch.load(d / "ckpt" / "ckpt_3.pt", weights_only=True)
    ck["params"][FIELD_FAULT[0]][FIELD_FAULT[1]] = float("inf")
    os.makedirs(d / "fault_ckpt", exist_ok=True)
    torch.save(ck, d / "fault_ckpt" / "ckpt_3.pt")
    rec = gf.main(["--mode", "replay", "--ckpt-dir", str(d / "fault_ckpt"), "--replay-steps",
                   "3", "--max-stash", "2", "--out", str(d / "fault_out")] + _base(d))
    assert rec["from_step"] == 3 and rec["events"] == [3, 4, 5]
    assert [os.path.basename(p) for p in rec["stashes"]] == ["stash_step3.npz",
                                                              "stash_step4.npz"]
    assert all(m["grad_skips"] == i + 1 for i, m in enumerate(rec["metrics"]))
    tr, state, batch, generator, step = gf.load_stash(
        argparse.Namespace(**vars(gf_args(d)), stash=rec["stashes"][0]))
    assert step == 3 and torch.isinf(state.module.state_dict()[FIELD_FAULT[0]][FIELD_FAULT[1]])
    assert {"points", "gt_rgb", "lang"} <= set(batch)
