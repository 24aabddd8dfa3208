"""The port's parallel/ (data, ray and tensor parallelism on
torch.distributed) against the JAX code that tests/test_sharding.py holds,
in gloo processes on the CPU at the tiny widths of that file. The JAX
functions run single-device on the same weights (numpy draws in the flax
tree, converted) and the same draws; the ranks (tests/_torch_parallel_ranks.py)
are spawned by `parallel.mesh.run_ranks`, each group with its own deadline.

Tolerances: the ray-split render 2e-4 / 2e-5 (test_sharding.py:20); the
dp PerAct step's loss 1e-4 relative to JAX's single-device step (:62), its
parameters after AdamW within test_torch_train_nerfact's rule of the port's
one-rank step, its BatchNorm statistics 1e-5 of their scale of the one-rank
step's (and JAX's); the TP PerceiverIO forward 2e-3 / 2e-4 (:104) and its
gradients 2e-3 of each tensor's largest |g| against JAX's; ResnetFC TP 2e-4 /
2e-5 (:154); the joint steps (dp 2, tp 2) 1e-5 relative in every metric and
1e-4 of each gradient's largest |g| against the port's one-rank step (fp32
sums in another order); the clip's global norm 1e-6 relative. Each planted
fault (k|v cut contiguously, a row-parallel bias added on every rank,
BatchNorm statistics left local, a clip norm over local shards) must
break the check it concerns.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxPerceiverConfig
from real_robot_nerf_actor_tpu.models import PerceiverIO as JaxPerceiverIO
from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.models.resnetfc import ResnetFC as JaxResnetFC
from real_robot_nerf_actor_tpu.render import NeuralRenderer as JaxRenderer
from real_robot_nerf_actor_tpu.render import RendererConfig as JaxRenderCfg
from real_robot_nerf_actor_tpu_torch.convert import (
    Placement, flax_to_state_dict, gather_state_dict, shard_state_dict)
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig
from real_robot_nerf_actor_tpu_torch.parallel import MeshSpec, make_mesh, shard_params_rule
from real_robot_nerf_actor_tpu_torch.parallel.dryrun import (
    dryrun_multichip, gate_config, global_batch)
from real_robot_nerf_actor_tpu_torch.parallel.mesh import run_ranks
from real_robot_nerf_actor_tpu_torch.parallel.train_dp import global_draws
from real_robot_nerf_actor_tpu_torch.render import RendererConfig
from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer
from real_robot_nerf_actor_tpu_torch.train.peract import PerActTrainer
from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager
from tests import _torch_parallel_ranks as ranks
from tests.test_torch_train_nerfact import _assert_params_after_adamw
from tests.test_torch_train_peract import _batch, _configs, _jax_step, _numpy_params

TP_MODEL = dict(depth=2, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
                cross_dim_head=8, latent_dim_head=8, latent_heads=2, voxel_patch_size=5,
                final_dim=8, lang_emb_dim=16, lang_max_seq_len=4)
RANK_DEADLINE_S = 240
INVARIANT = "trans_decoder.bias"


def _rel_gap(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _assert_grads_close(got, want):
    """Each gradient within 1e-4 of its tensor's largest |g|; the trans
    decoder's bias (no gradient beyond rounding: the softmax CE does not see
    a shift of every trans logit) within 1e-5 of the largest gradient."""
    top = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        if n.endswith(INVARIANT):
            assert max(w.abs().max().item(), got[n].abs().max().item()) <= 1e-5 * top, n
            continue
        torch.testing.assert_close(got[n], w, rtol=0, atol=1e-4 * w.abs().max().item(),
                                   msg=lambda m: f"{n}: {m}")


def _one_rank_joint(cfg, sd, batch, draws):
    """The port's bare joint step on one process: (metrics, grads, params,
    buffers)."""
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(sd)
    state, m = tr.train_step(state, batch, None, **draws)
    named = dict(state.module.named_parameters())
    return ({k: v.item() for k, v in m.items()}, {n: p.grad for n, p in named.items()},
            {n: p.detach() for n, p in named.items()}, dict(state.module.named_buffers()))


def _joint_inputs():
    """The dryrun's tiny joint config, weights from seed 0 with every bias
    and the field's zero-initialised layers redrawn (so that a bias added
    twice shows), a global batch of 2 and its draws."""
    cfg = gate_config("tiny")
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    sd = {k: (v + 0.1 * torch.randn(v.shape, generator=g) if v.dim() == 1
              and "running" not in k else v).clone()
          for k, v in state.module.state_dict().items()}
    for k in sd:
        if "ResnetBlockFC" in k and k.endswith("Dense_1.weight"):
            sd[k] = torch.randn(sd[k].shape, generator=g) / sd[k].shape[1] ** 0.5
    batch = global_batch(tr, 2)
    return dict(cfg=cfg, sd=sd, batch=batch,
                draws=global_draws(tr, 2, torch.Generator().manual_seed(1)))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """JAX's replicated PerceiverIO and ResnetFC, then the TP ranks."""
    jcfg = JaxPerceiverConfig(**TP_MODEL)
    net = JaxPerceiverIO(jcfg)
    v = jcfg.voxel_size
    vox = jax.random.normal(jax.random.key(0), (1, v, v, v, jcfg.initial_dim))
    proprio = jnp.asarray(np.random.default_rng(1).standard_normal((1, 7)), jnp.float32)
    lang = jnp.asarray(np.random.default_rng(2).standard_normal(
        (1, jcfg.lang_max_seq_len, jcfg.lang_emb_dim)), jnp.float32)
    params = {"params": _numpy_params(net.init(jax.random.key(1), vox, proprio,
                                               lang)["params"])}
    base = net.apply(params, vox, proprio, lang)
    rng = np.random.default_rng(4)
    ws = [jnp.asarray(rng.standard_normal(np.shape(o)), jnp.float32) for o in base]
    grads = jax.grad(lambda p: sum((o * w).sum() for o, w in zip(
        net.apply(p, vox, proprio, lang), ws)))(params)

    jr = JaxResnetFC(d_out=4, n_blocks=2, d_latent=0, d_hidden=32)
    x = jax.random.normal(jax.random.key(0), (16, 8))
    pr = jr.init(jax.random.key(1), x)
    r = np.random.default_rng(5)
    pr = jax.tree.map(lambda a: jnp.asarray(r.standard_normal(np.shape(a)) * 0.3,
                                            jnp.float32), pr)
    base_r = jr.apply(pr, x)[0]

    t = torch.from_numpy
    joint = _joint_inputs()
    inp = {"perceiver": dict(cfg=PerceiverConfig(**TP_MODEL),
                             sd=flax_to_state_dict(jax.device_get(params)),
                             args=(t(np.array(vox)), t(np.array(proprio)), t(np.array(lang))),
                             w=[t(np.array(w)) for w in ws]),
           "resnetfc": dict(kw=dict(d_in=8, d_out=4, n_blocks=2, d_latent=0, d_hidden=32),
                            sd=flax_to_state_dict(jax.device_get(pr)), x=t(np.array(x))),
           "joint": joint}
    d = tmp_path_factory.mktemp("tp")
    torch.save(inp, d / "in.pt")
    run_ranks(ranks.tp_worker, 2, (str(d / "in.pt"), str(d)), timeout_s=RANK_DEADLINE_S)
    res = torch.load(d / "tp.pt", weights_only=False)
    return dict(res=res, out=[np.asarray(o) for o in base],
                grads=flax_to_state_dict(jax.device_get(grads)), resnet=np.asarray(base_r),
                joint=joint, one_rank=_one_rank_joint(joint["cfg"], joint["sd"],
                                                      joint["batch"], joint["draws"]),
                ckpt=str(d / "ckpt"))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's single-device render and PerAct step, then the dp ranks."""
    bounds = (-1., -1., -1., 1., 1., 1.)
    field = dict(d_latent=4, d_embed=4, d_hidden=16, n_blocks=2, combine_layer=1,
                 coord_bounds=bounds)
    rkw = dict(image_width=8, image_height=8, n_coarse=4, n_fine=2, n_fine_depth=0)
    jr = JaxRenderer(JaxRenderCfg(field=JaxField(**field), **rkw))
    rparams = jr.init_params(jax.random.key(0))
    r = np.random.default_rng(7)
    rparams = jax.tree.map(lambda a: jnp.asarray(r.standard_normal(np.shape(a)) * 0.3,
                                                 jnp.float32), rparams)
    vox = jax.random.normal(jax.random.key(1), (1, 4, 4, 4, 4))
    rng = np.random.default_rng(0)
    rays = np.concatenate([rng.standard_normal((64, 3)).astype(np.float32) * 0.1,
                           rng.standard_normal((64, 3)).astype(np.float32),
                           np.full((64, 1), 0.5, np.float32),
                           np.full((64, 1), 2.0, np.float32)], -1)
    key = jax.random.key(2)
    base = jr.render_rays(rparams, vox, jnp.asarray(rays), key)["fine"].rgb
    k_coarse, k_fine, _, _, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_fine)
    t = torch.from_numpy
    rdraws = {"coarse_u": jax.random.uniform(k_coarse, (64, 4)),
              "fine_u": jax.random.uniform(k_u, (64, 2)),
              "fine_jitter": jax.random.uniform(k_j, (64, 2))}

    jax_cfg, cfg = _configs(input_encoder="unet")
    batch = _batch()
    jax_m, params, _, draws, stats, new_stats = _jax_step(jax_cfg, batch)
    sd = flax_to_state_dict({"params": params, **stats})
    tbatch = {k: t(v) for k, v in batch.items()}
    tr = PerActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(sd)
    state, m1 = tr.train_step(state, tbatch, draws=t(draws))
    one = dict(metrics={k: v.item() for k, v in m1.items()},
               params={n: p.detach() for n, p in state.module.named_parameters()},
               buffers=dict(state.module.named_buffers()))

    joint = _joint_inputs()
    inp = {"render": dict(cfg=RendererConfig(field=NerfFieldConfig(**field), **rkw),
                          sd=flax_to_state_dict(jax.device_get(rparams)), vox=t(np.array(vox)),
                          rays=t(rays), draws={k: t(np.array(v)) for k, v in rdraws.items()}),
           "peract": dict(cfg=cfg, sd=sd, batch=tbatch, draws=t(draws)),
           "joint": joint}
    d = tmp_path_factory.mktemp("dp")
    torch.save(inp, d / "in.pt")
    run_ranks(ranks.dp_worker, 2, (str(d / "in.pt"), str(d)), timeout_s=RANK_DEADLINE_S)
    res = [torch.load(d / f"dp{i}.pt", weights_only=False) for i in range(2)]
    return dict(res=res, render=np.asarray(base), jax_m=jax_m,
                jax_stats=flax_to_state_dict(jax.device_get(new_stats)), one=one,
                optim=jax_cfg.train.optim,
                joint_one=_one_rank_joint(joint["cfg"], joint["sd"], joint["batch"],
                                          joint["draws"]))


# ------------------------------------------------------------------ mesh
def test_mesh_axes(tp_run):
    """MeshSpec resolves as JAX's; 2 ranks as data 1 x model 2, and the
    default spec over them as data 2; one process without a group is one
    rank whose collectives are no-ops."""
    assert MeshSpec(data=-1, model=2).resolve(8) == MeshSpec(data=4, model=2)
    assert MeshSpec(data=2, model=2).resolve(8) == MeshSpec(data=2, model=2)
    res = tp_run["res"]
    assert res["mesh"] == {"data": 1, "model": 2} and res["index"] == (0, 0)
    assert res["resolved"] == {"data": 2, "model": 1}
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None


def test_shard_hidden(tp_run):
    """shard_hidden (JAX's layout hint, here a real cut): rank 0's half of
    a replicated activation, the gradient summed over the model ranks and
    zero-padded back to the whole; a width that does not divide stays
    whole; outside a context, the identity."""
    from real_robot_nerf_actor_tpu_torch.parallel import shard_hidden
    y, grad, odd = tp_run["res"]["shard_hidden"]
    assert torch.equal(y, torch.arange(4.0))
    assert torch.equal(grad, torch.tensor([1.0] * 4 + [2.0] * 4))
    assert torch.equal(odd, torch.arange(7.0))
    x = torch.arange(6.0)
    assert shard_hidden(x) is x


def test_shard_and_gather_round_trip():
    """convert.shard_state_dict / gather_state_dict by the placement of a
    PerceiverIO: the shards put back equal the whole state_dict; a fused
    column leaf's shard takes its rank's rows of each chunk (k and v), not
    a contiguous block."""
    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    net = PerceiverIO.initialized(PerceiverConfig(**TP_MODEL), torch.Generator().manual_seed(0))
    sd = net.state_dict()

    class TwoWay:
        shape = {"data": 1, "model": 2}

    pl = shard_params_rule(TwoWay, net)
    kv = "self_attn_0.MHAttention_0.to_kv.weight"
    assert pl[kv] == Placement("column", chunks=2)
    assert pl["self_attn_0.MHAttention_0.to_out.weight"] == Placement("row")
    assert "self_attn_0.MHAttention_0.to_out.bias" not in pl
    assert not any(k.startswith("cross_attend.") for k in pl)   # cross_heads 1: replicated
    shards = [shard_state_dict(sd, pl, r, 2) for r in range(2)]
    whole = gather_state_dict(shards, pl)
    assert set(whole) == set(sd)
    for k, v in sd.items():
        assert torch.equal(whole[k], v), k
    inner = sd[kv].shape[0] // 2
    assert torch.equal(shards[1][kv], torch.cat([sd[kv][inner // 2:inner],
                                                 sd[kv][inner + inner // 2:]]))
    assert shards[0]["self_attn_0.MHAttention_0.to_out.weight"].shape[1] == inner // 2


# ------------------------------------------------------------------- tp
def _perceiver_check(tp_run, fault):
    """(worst output gap over its bound, worst gradient gap over its bound)
    of the TP forward with `fault` against JAX's replicated one."""
    r = tp_run["res"][f"perceiver/{fault}"]
    out_ratio = max(np.max(np.abs(o.numpy() - w) / (2e-4 + 2e-3 * np.abs(w)))
                    for o, w in zip(r["out"], tp_run["out"]))
    grad_ratio = max(_rel_gap(r["grads"][n], w) / 2e-3 for n, w in tp_run["grads"].items()
                     if w.abs().max() > 0)
    return out_ratio, grad_ratio


def test_tp_perceiver_matches_replicated(tp_run):
    """PerceiverIO over 2 model ranks (self-attention heads, GEGLU hidden cut;
    cross-attention replicated) against JAX's replicated forward and its
    gradients of a fixed projection of every output."""
    r = tp_run["res"]["perceiver/None"]
    assert any("self_attn_0.MHAttention_0.to_kv" in k for k in r["placements"])
    out_ratio, grad_ratio = _perceiver_check(tp_run, None)
    assert out_ratio <= 1.0 and grad_ratio <= 1.0, (out_ratio, grad_ratio)


@pytest.mark.parametrize("fault", ["kv_contiguous", "bias_every_rank"])
def test_tp_perceiver_check_sees_planted_faults(tp_run, fault):
    out_ratio, grad_ratio = _perceiver_check(tp_run, fault)
    assert max(out_ratio, grad_ratio) > 10.0, (fault, out_ratio, grad_ratio)


@pytest.mark.parametrize("fault", [None, "bias_every_rank"])
def test_tp_resnetfc_matches_replicated(tp_run, fault):
    got = tp_run["res"][f"resnetfc/{fault}"].numpy()
    ok = np.allclose(got, tp_run["resnet"], rtol=2e-4, atol=2e-5)
    assert ok == (fault is None), np.abs(got - tp_run["resnet"]).max()


def test_clip_global_norm_under_tp(tp_run):
    """The clip's global norm over sharded gradients: the sharded leaves'
    squares summed over the model ranks, each replicated leaf once; taken
    over local shards only it is wrong."""
    grads = tp_run["res"]["perceiver/None"]["grads"]
    want = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])).item()
    got, local = (tp_run["res"][f"clip_norm/{f}"] for f in (None, "clip_local"))
    assert abs(got - want) <= 1e-6 * want
    assert abs(local - want) > 1e-3 * want


def test_tp_joint_step_matches_one_rank(tp_run):
    """The tiny joint step on 2 model ranks (policy heads and FF, field
    blocks cut) against the port's one-rank step."""
    got = tp_run["res"]["joint"]
    m1, g1, _, b1 = tp_run["one_rank"]
    assert got["n_sharded"] > 0
    for k, w in m1.items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5, err_msg=k)
    _assert_grads_close(got["grads"], g1)
    for n, w in b1.items():
        torch.testing.assert_close(got["buffers"][n], w, rtol=0, atol=1e-5 * w.abs().max().item())


def test_tp_checkpoint_is_whole_and_loads_at_world_size_1(tp_run):
    """The TP run's checkpoint holds whole tensors: it restores (with its
    optimizer) into a one-process state, with the one-rank step's
    parameters after AdamW."""
    j = tp_run["joint"]
    tr = NerfActTrainer(j["cfg"], device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    restored = CheckpointManager(tp_run["ckpt"]).restore(state)
    assert restored is not None and restored.step == 1 and restored.optimizer.count == 1
    assert np.isfinite(tp_run["res"]["joint_after_save"])
    got = {n: p.detach() for n, p in restored.module.named_parameters()}
    _assert_params_after_adamw(got, tp_run["one_rank"][2], j["cfg"].peract.train.optim.lr)


# ------------------------------------------------------------------- dp
def test_ray_split_render_matches_single_device(dp_run):
    """Rays split over 2 data ranks render as JAX renders them all at once
    (test_sharding.py:20)."""
    got = np.concatenate([r["render"].numpy() for r in dp_run["res"]])
    np.testing.assert_allclose(got, dp_run["render"], rtol=2e-4, atol=2e-5)


def test_dp_peract_step_matches_jax_and_one_rank(dp_run):
    """The PerAct step (UNet encoder, BatchNorm on batch statistics) with its
    batch of 2 over 2 data ranks: the loss within 1e-4 of JAX's
    single-device step, the parameters after AdamW as the port's one-rank
    step's, the running statistics the global batch's."""
    one, res = dp_run["one"], dp_run["res"]
    for r in res:
        got = r["peract/None"]
        np.testing.assert_allclose(got["metrics"]["loss"], dp_run["jax_m"]["loss"], rtol=1e-4)
        _assert_params_after_adamw(got["params"], one["params"], dp_run["optim"].lr)
        for n, w in one["buffers"].items():
            torch.testing.assert_close(got["buffers"][n], w, rtol=0,
                                       atol=1e-5 * w.abs().max().item())
            if n in dp_run["jax_stats"]:
                torch.testing.assert_close(got["buffers"][n], dp_run["jax_stats"][n], rtol=0,
                                           atol=1e-5 * w.abs().max().item())


def test_dp_batchnorm_statistics_left_local_fail(dp_run):
    """With the moments left local each rank normalises by its own sample:
    its running statistics leave the global batch's by far more than the
    check's 1e-5."""
    one = dp_run["one"]["buffers"]
    gap = max(_rel_gap(dp_run["res"][0]["peract/bn_local"]["buffers"][n], w)
              for n, w in one.items())
    assert gap > 1e-3, gap


def test_dp_joint_step_matches_one_rank(dp_run):
    """The tiny joint step over 2 data ranks (sample 0's d0 and view
    broadcast, 4 rays a rank) against the port's one-rank step."""
    m1, g1, _, b1 = dp_run["joint_one"]
    for r in dp_run["res"]:
        got = r["joint"]
        for k, w in m1.items():
            np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5, err_msg=k)
        _assert_grads_close(got["grads"], g1)
        for n, w in b1.items():
            torch.testing.assert_close(got["buffers"][n], w, rtol=0,
                                       atol=1e-5 * w.abs().max().item())


def test_dryrun_multichip_tiny_dp2_tp2():
    """The port's dryrun_multichip: 4 gloo ranks, dp 2 x tp 2, one joint
    step within 1e-3 of the one-rank step's loss."""
    out = dryrun_multichip(4, scale="tiny", device="cpu", timeout_s=RANK_DEADLINE_S)
    assert out["mesh"] == {"data": 2, "model": 2} and out["rel_err"] < 1e-3
    assert np.isfinite(out["loss_total"])


def test_dryrun_multichip_runs_on_the_card_unless_asked(monkeypatch):
    """The entry point runs on the card by default: without CUDA it raises
    before it spawns a rank (device="cpu", as above, asks for the CPU)."""
    from real_robot_nerf_actor_tpu_torch.parallel import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2, scale="tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--n", "2", "--scale", "tiny"])


def test_models_hold_no_parallel_code():
    """The tensor-parallel cut lives in parallel/: no model module imports
    it, and a PerceiverIO cut by shard_module_ keeps the names and
    placement-sized shapes of its state_dict (checkpoints stay loadable)."""
    import pathlib
    from real_robot_nerf_actor_tpu_torch.models import PerceiverIO
    from real_robot_nerf_actor_tpu_torch.parallel import Mesh, RowParallelDense, shard_module_
    models = pathlib.Path(PerceiverIO.__module__.replace(".", "/")).parent
    for f in (pathlib.Path(__file__).resolve().parent.parent / models).glob("*.py"):
        assert ".parallel" not in f.read_text(), f.name
    net = PerceiverIO(PerceiverConfig(**TP_MODEL))
    whole = {k: v.shape for k, v in net.state_dict().items()}
    mesh = Mesh(MeshSpec(data=1, model=2), 1, {})
    placements = shard_params_rule(mesh, net)
    shard_module_(mesh, net, placements)
    cut = {k: v.shape for k, v in net.state_dict().items()}
    assert cut.keys() == whole.keys()
    for k, shape in whole.items():
        if k in placements:
            d = placements[k].dim
            assert cut[k][d] * 2 == shape[d], k
            assert cut[k][:d] + cut[k][d + 1:] == shape[:d] + shape[d + 1:], k
        else:
            assert cut[k] == shape, k
    rows = [n for n, m in net.named_modules() if isinstance(m, RowParallelDense)]
    assert rows and all(n.endswith(("to_out", "Dense_1")) for n in rows)


def test_tp_layers_refuse_outside_the_context():
    """A layer cut to its shard computes only its part: outside
    tensor_parallel it raises instead of returning a wrong output."""
    from real_robot_nerf_actor_tpu_torch.models.perceiver import GEGLUFeedForward
    from real_robot_nerf_actor_tpu_torch.parallel import (
        Mesh, MeshSpec, shard_module_, shard_params_rule, tensor_parallel)
    mesh = Mesh(MeshSpec(data=1, model=2), 0, {})   # rank 0 of two, no process group
    ff = GEGLUFeedForward(8, torch.float32)
    shard_module_(mesh, ff, shard_params_rule(mesh, ff))
    assert ff.Dense_0.weight.shape == (32, 8) and ff.Dense_1.weight.shape == (8, 16)
    with pytest.raises(RuntimeError, match="tensor_parallel"):
        ff(torch.zeros(1, 8))            # the column-parallel Dense_0's hook
    with pytest.raises(RuntimeError, match="tensor_parallel"):
        ff.Dense_1(torch.zeros(1, 16))   # the row-parallel Dense_1
    with tensor_parallel(mesh):
        assert ff(torch.zeros(1, 8)).shape == (1, 8)


def test_chip_smoke_has_parallel_and_checkpoint_phases():
    """chip_smoke.py's phases 13 and 14: the legs a-d on configs/nerfact.yaml
    in setting b (and serve.yaml's policy) with their planted faults, and
    the tools on a trained checkpoint; both called from main."""
    import importlib.util
    import inspect
    import pathlib
    import yaml
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = inspect.getsource(cs.parallel_phase) + inspect.getsource(cs.parallel_rank)
    for needle in ('"nccl"', "run_ranks(", "make_data_parallel_step(", '"bn_local"',
                   '"kv_contiguous"', '"bias_every_rank"', "tensor_parallel(",
                   "deterministic_algorithms(", "BN_TOL", "LATENT_TOL", "cpu/one_rank",
                   '"clip_local"', "nonfinite_check", "FP32_K", "cpu/one_rank32"):
        assert needle in src, needle
    src = inspect.getsource(cs.checkpoint_phase)
    for needle in ("nerfact.main(", "serve.build_server(", "serve.main(", "eval_quality.main(",
                   "analyze_bc.main(", "extract_nerf_feat.main(", "RGB_TOL", "PSNR_MIN"):
        assert needle in src, needle
    main = inspect.getsource(cs.main)
    assert main.index("camera_phase(") < main.index("parallel_phase(") \
        < main.index("checkpoint_phase(")
    with open(repo / "configs" / "nerfact.yaml") as f:
        assert yaml.safe_load(f)["peract"]["train"]["optim"]["warmup_steps"] == 500
    want = load_config(NerfActConfig, str(repo / "configs" / "nerfact.yaml"))
    got = cs.setting_b()
    assert got.peract.model.conv_backend == "pallas" and got.renderer.fused_gather is True
    assert got.peract.model == dataclasses.replace(want.peract.model, conv_backend="pallas")
    assert got.renderer.field == want.renderer.field


@pytest.mark.parametrize("joint", [False, True])
def test_one_rank_step_draws_as_the_bare_step(joint):
    """make_data_parallel_step on one process (no process group) takes its
    draws from the generator in the order the bare step does: the same
    seed gives the same loss and gradients, bit for bit."""
    from real_robot_nerf_actor_tpu_torch.parallel.train_dp import make_data_parallel_step
    if joint:
        tr = NerfActTrainer(gate_config("tiny"), device="cpu")
        batch = global_batch(tr, 2)
    else:
        tr = PerActTrainer(_configs()[1], device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    runs = []
    for wrapped in (False, True):
        state = tr.init_state(torch.Generator().manual_seed(0))
        step = tr.train_step
        if wrapped:
            step, place_state, place_batch = make_data_parallel_step(
                tr.train_step, make_mesh(), state, batch)
            state = place_state(state)
        state, m = step(state, batch, torch.Generator().manual_seed(7))
        runs.append((m, {n: p.grad for n, p in state.module.named_parameters()}))
    (m0, g0), (m1, g1) = runs
    assert {k: v.item() for k, v in m0.items()} == {k: v.item() for k, v in m1.items()}
    for n, g in g0.items():
        assert torch.equal(g, g1[n]), n
