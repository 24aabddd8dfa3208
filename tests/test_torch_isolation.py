"""The PyTorch port stands alone: no module of real_robot_nerf_actor_tpu_torch
and not chip_smoke.py imports jax, flax or the JAX package (a static scan of
the import statements); its entry points refuse CUDA where there is none
instead of falling back to the CPU; its kernel wrappers refuse tensors they
cannot launch on; and its config dataclasses read the repo's YAML files as
the JAX package does."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import real_robot_nerf_actor_tpu_torch
from real_robot_nerf_actor_tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = pathlib.Path(real_robot_nerf_actor_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "real_robot_nerf_actor_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(REPO)} imports {name}"


def test_policy_server_refuses_missing_cuda(monkeypatch):
    from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig
    from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
    from real_robot_nerf_actor_tpu_torch.train import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.PolicyServer(serve.ServeConfig(), PerceiverConfig(),
                           VoxelizerSpec(), {}, np.zeros((77, 512), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--steps", "1"])


def test_kernel_build_refuses_missing_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the kernels cannot be built: loading raises
    instead of handing back a plain version."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention")


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; anything else goes to the
    kernel path, which refuses what it cannot launch on."""
    from real_robot_nerf_actor_tpu_torch.ops.attention_cuda import flash_attention
    from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3
    from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import spatial_stats_3d
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_k3(torch.empty((1, 4, 4, 4, 8), device="meta"),
                  torch.empty((3, 3, 3, 8, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        spatial_stats_3d(torch.empty((1, 4, 4, 4, 8), device="meta"))


@pytest.mark.parametrize("path,section", [("configs/peract.yaml", None),
                                          ("configs/serve.yaml", "peract")])
def test_configs_load_like_jax(path, section):
    yaml = pytest.importorskip("yaml")
    from real_robot_nerf_actor_tpu.train.peract import PerActConfig as JaxCfg
    from real_robot_nerf_actor_tpu.utils.config import from_dict as jax_from_dict
    from real_robot_nerf_actor_tpu.utils.config import to_dict as jax_to_dict
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import (
        apply_override, from_dict, load_config, to_dict)
    data = yaml.safe_load((REPO / path).read_text())
    data = data[section] if section else data
    ours = from_dict(PerActConfig, data)
    assert to_dict(ours) == jax_to_dict(jax_from_dict(JaxCfg, data))
    if section is None:
        assert load_config(PerActConfig, str(REPO / path)) == ours
    ours = apply_override(ours, "model.conv_backend", "pallas")
    assert ours.model.conv_backend == "pallas"


def test_render_wrappers_refuse_non_cpu_non_cuda_tensors():
    from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
    from real_robot_nerf_actor_tpu_torch.ops.ray_expand_cuda import ray_expand
    from real_robot_nerf_actor_tpu_torch.ops.resnetfc_cuda import (
        fused_gather_resnetfc_int8, fused_resnetfc_int8)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        corner_lerp(torch.empty((4, 64), **meta), torch.empty((8, 4), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        ray_expand(torch.empty((256, 8), **meta), torch.empty((256, 2), **meta),
                   (4, 4, 4), (0, 0, 0, 1, 1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        fused_resnetfc_int8(torch.empty((4, 128), **meta), {})
    with pytest.raises(ValueError, match="CUDA"):
        fused_gather_resnetfc_int8(torch.empty((4, 64), **meta),
                                   torch.empty(4, dtype=torch.int32, **meta),
                                   torch.empty((8, 4), **meta),
                                   torch.empty((24, 4), **meta), {}, d_latent=8)


@pytest.mark.parametrize("path", ["configs/serve.yaml", "configs/nerfact.yaml"])
def test_nerfact_configs_load_like_jax(path):
    """The whole file (peract, renderer, lambda_*) into NerfActConfig."""
    yaml = pytest.importorskip("yaml")
    from real_robot_nerf_actor_tpu.train.nerfact import NerfActConfig as JaxCfg
    from real_robot_nerf_actor_tpu.utils.config import from_dict as jax_from_dict
    from real_robot_nerf_actor_tpu.utils.config import to_dict as jax_to_dict
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config, to_dict
    data = yaml.safe_load((REPO / path).read_text())
    ours = load_config(NerfActConfig, str(REPO / path))
    assert to_dict(ours) == jax_to_dict(jax_from_dict(JaxCfg, data))
    if path.endswith("serve.yaml"):
        f = ours.renderer.field
        assert (f.mlp_backend, f.int8_static_act, f.mask_outside) == (
            "pallas_int8", True, True)
        assert ours.renderer.use_ray_plan and ours.renderer.occ_source == "auto"


def test_chip_smoke_renders_serve_yaml():
    """chip_smoke.py's renderer config (the card machine has no PyYAML) is
    the `renderer:` section of configs/serve.yaml."""
    yaml = pytest.importorskip("yaml")
    import importlib.util
    from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig
    from real_robot_nerf_actor_tpu_torch.render import RendererConfig
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ours = RendererConfig(field=NerfFieldConfig(**cs.SERVE_FIELD), **cs.SERVE_RENDERER)
    assert ours == load_config(NerfActConfig, str(REPO / "configs/serve.yaml")).renderer


def test_training_modules_import_without_jax():
    """The training slice's modules import in a process where jax, flax,
    optax and the JAX package cannot be imported."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import real_robot_nerf_actor_tpu_torch.ops.se3_aug\n"
        "import real_robot_nerf_actor_tpu_torch.utils.logger\n"
        "import real_robot_nerf_actor_tpu_torch.train.trainer\n"
        "import real_robot_nerf_actor_tpu_torch.train.peract\n"
        "import real_robot_nerf_actor_tpu_torch.train.nerfact\n"
        "import real_robot_nerf_actor_tpu_torch.eval.metrics\n"
        "import real_robot_nerf_actor_tpu_torch.convert\n"
        "import real_robot_nerf_actor_tpu_torch.models.clip_text\n"
        "import real_robot_nerf_actor_tpu_torch.data.kitchen\n"
        "import real_robot_nerf_actor_tpu_torch.data.native_loader\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_trainer_refuses_missing_cuda(monkeypatch):
    """PerActTrainer (and so its train_step) and the training entry point
    default to CUDA and raise without it."""
    from real_robot_nerf_actor_tpu_torch.train import peract
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        peract.PerActTrainer(peract.PerActConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        peract.main(["--steps", "1"])


def test_chip_smoke_trains_peract_yaml():
    """chip_smoke.py's train config (the card machine has no PyYAML) is
    configs/peract.yaml as written."""
    yaml = pytest.importorskip("yaml")
    import importlib.util
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict, load_config
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert yaml.safe_load((REPO / "configs/peract.yaml").read_text()) == cs.PERACT
    assert from_dict(PerActConfig, cs.PERACT) == load_config(
        PerActConfig, str(REPO / "configs/peract.yaml"))


def test_chip_smoke_trains_nerfact_yaml():
    """chip_smoke.py's joint-step config is configs/nerfact.yaml as written."""
    yaml = pytest.importorskip("yaml")
    import importlib.util
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict, load_config
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert yaml.safe_load((REPO / "configs/nerfact.yaml").read_text()) == cs.NERFACT
    assert from_dict(NerfActConfig, cs.NERFACT) == load_config(
        NerfActConfig, str(REPO / "configs/nerfact.yaml"))


def test_port_imports_no_pil_or_regex():
    """The card machine has neither: the PNG codec and the tokenizer's word
    pattern use the standard library."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("PIL", "regex"), \
                f"{f.relative_to(REPO)} imports {name}"


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                yield first.value


def test_port_reaches_into_no_file_of_the_jax_package():
    """No string in the port's code (docstrings aside) names the JAX
    package's directory, and no C++/CUDA source includes from it: the port
    keeps its own copies, the PLY loader's C++ source included."""
    import re
    jax_pkg = re.compile(r"real_robot_nerf_actor_tpu(?!_torch)")
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text())
        docs = {id(d) for d in _docstrings(tree)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not jax_pkg.search(node.value), f"{f.relative_to(REPO)}: {node.value!r}"
    sources = [p for ext in ("*.cu", "*.cuh", "*.cpp", "*.h") for p in PORT.rglob(ext)]
    assert any(p.name == "ply_loader.cpp" for p in sources)
    for f in sources:
        for line in f.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not jax_pkg.search(line), f"{f.relative_to(REPO)}: {line}"


def test_data_and_language_modules_run_without_jax_pil_or_regex(tmp_path):
    """In a process where jax, flax, the JAX package, PIL and regex cannot
    be imported: write a tiny multi-kitchen dataset (the text tower on the
    CPU), read it back through ReplaySource (PNGs included), tokenize with
    the BPE, and build the native PLY loader."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN + ('PIL', 'regex')!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from real_robot_nerf_actor_tpu_torch.data import kitchen, native_loader\n"
        "from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries\n"
        "from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource\n"
        "from real_robot_nerf_actor_tpu_torch.models.clip_bpe import ClipBPETokenizer\n"
        "import real_robot_nerf_actor_tpu_torch.data.calibration\n"
        "root = sys.argv[1]\n"
        "kitchen.write_multi_kitchen_dataset(root, n_kitchens=1, n_tasks=2, n_demos=1,\n"
        "    image_hw=(6, 8), d_embed=4, n_points=500, device='cpu')\n"
        "e = load_multitask_entries(root)[1]\n"
        "src = ReplaySource(e['root'], 1)\n"
        "v = src.view(0, 2)\n"
        "assert v['rgb'].shape == (6, 8, 3) and v['embed'].shape == (6, 8, 4)\n"
        "assert src.holdout_view(0, 1)['rgb'].max() > 0 and e['lang'].shape == (77, 512)\n"
        "pts = native_loader.read_ply_native(root + '/k0_t0/real0/pcd0.ply')[0]\n"
        "assert len(pts) > 2000\n"
        "tok = ClipBPETokenizer([('g', 'r'), ('gr', 'a')])\n"
        "assert tok.tokenize('grab the café 42')[0, 0] == tok.sot_id\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "m")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_has_a_replay_phase():
    """chip_smoke.py drives the recorded-demo path: it writes a multi-kitchen
    dataset with the port, trains configs/nerfact.yaml on it and runs the
    multi-kitchen eval with the serving field of configs/serve.yaml."""
    import importlib.util
    import inspect
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = inspect.getsource(cs.replay_phase)
    for call in ("write_multi_kitchen_dataset(", "multi_replay_data(",
                 "make_multi_replay_eval("):
        assert call in src or call in inspect.getsource(cs), call
    assert "replay_phase(" in inspect.getsource(cs.main)
    assert cs.REPLAY_DATA["image_hw"] == (cs.NERFACT["renderer"]["image_height"],
                                          cs.NERFACT["renderer"]["image_width"])
    assert cs.REPLAY_DATA["d_embed"] == cs.NERFACT["renderer"]["field"]["d_embed"]


def test_featurenerf_pipeline_runs_without_jax(tmp_path):
    """In a process where jax, flax and the JAX package cannot be imported:
    import every module of the FeatureNeRF slice, write two tiny scenes,
    dump a 12-layer teacher's features into them, take one train step and
    evaluate novel views on the CPU."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import real_robot_nerf_actor_tpu_torch.eval.correspondence\n"
        "import real_robot_nerf_actor_tpu_torch.eval.extract\n"
        "import real_robot_nerf_actor_tpu_torch.models.pixelnerf\n"
        "import real_robot_nerf_actor_tpu_torch.render.pixelnerf_renderer\n"
        "import real_robot_nerf_actor_tpu_torch.utils.pca\n"
        "from real_robot_nerf_actor_tpu_torch.data import scene_dataset as sd\n"
        "from real_robot_nerf_actor_tpu_torch.eval import novel\n"
        "from real_robot_nerf_actor_tpu_torch.models.encoder2d import SpatialEncoderConfig\n"
        "from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfConfig\n"
        "from real_robot_nerf_actor_tpu_torch.render.pixelnerf_renderer import (\n"
        "    PixelNerfRendererConfig)\n"
        "from real_robot_nerf_actor_tpu_torch.train import distill2d, featurenerf as fn\n"
        "root = sys.argv[1]\n"
        "for i in range(2):\n"
        "    sd.synthesize_scene_npz(f'{root}/s{i}.npz', n_views=3, hw=(16, 16), seed=i)\n"
        "distill2d.dump_teacher_features(root, pca=4, embed_dim=12, device='cpu')\n"
        "cfg = fn.FeatureNerfConfig(model=PixelNerfConfig(d_embed=4, d_hidden=8, n_blocks=2,\n"
        "    combine_layer=1, encoder=SpatialEncoderConfig((4, 4, 8), 1)),\n"
        "    renderer=PixelNerfRendererConfig(4, 2, 1), ray_batch_size=8, lambda_coord=0.1)\n"
        "tr = fn.FeatureNerfTrainer(cfg, device='cpu')\n"
        "st = tr.init_state(torch.Generator().manual_seed(0))\n"
        "ds = sd.SceneDataset(root)\n"
        "st, m = tr.train_step(st, next(tr.scene_data(ds)), torch.Generator().manual_seed(1))\n"
        "assert torch.isfinite(m['loss'])\n"
        "res = novel.evaluate(tr, st.module, sd.SceneDataset(root, 'val'), n_scenes=1)\n"
        "assert len(res['scenes']) == 1 and ds[0].features.shape == (3, 2, 2, 4)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_featurenerf_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    """The FeatureNeRF trainer, the student trainer and the three CLIs
    default to CUDA and raise without it."""
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import synthesize_scene_npz
    from real_robot_nerf_actor_tpu_torch.eval import novel
    from real_robot_nerf_actor_tpu_torch.train import distill2d, featurenerf
    synthesize_scene_npz(str(tmp_path / "s.npz"), n_views=2, hw=(8, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: featurenerf.FeatureNerfTrainer(featurenerf.FeatureNerfConfig()),
                 lambda: distill2d.Student2DTrainer(distill2d.Distill2DConfig()),
                 lambda: featurenerf.main(["--steps", "1", "--data-root", str(tmp_path)]),
                 lambda: distill2d.main(["--data-root", str(tmp_path)]),
                 lambda: novel.main(["--data-root", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_featurenerf_config_loads_like_jax():
    """configs/featurenerf.yaml into both packages' FeatureNerfConfig."""
    yaml = pytest.importorskip("yaml")
    from real_robot_nerf_actor_tpu.train.featurenerf import FeatureNerfConfig as JaxCfg
    from real_robot_nerf_actor_tpu.utils.config import from_dict as jax_from_dict
    from real_robot_nerf_actor_tpu.utils.config import to_dict as jax_to_dict
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import FeatureNerfConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config, to_dict
    path = REPO / "configs/featurenerf.yaml"
    ours = load_config(FeatureNerfConfig, str(path))
    assert to_dict(ours) == jax_to_dict(jax_from_dict(JaxCfg, yaml.safe_load(path.read_text())))


def test_chip_smoke_trains_featurenerf_yaml():
    """chip_smoke.py's FeatureNeRF config is configs/featurenerf.yaml as
    written, and its one override is the z band."""
    yaml = pytest.importorskip("yaml")
    import importlib.util
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import FeatureNerfConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict, load_config
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    path = REPO / "configs/featurenerf.yaml"
    assert yaml.safe_load(path.read_text()) == cs.FEATURENERF
    assert from_dict(FeatureNerfConfig, cs.FEATURENERF) == load_config(FeatureNerfConfig,
                                                                        str(path))
    assert cs.FEATURENERF_OVERRIDE == {"z_near": 1.2, "z_far": 4.0}
    assert cs.FNERF_TEACHER["embed_dim"] == cs.FEATURENERF["model"]["d_embed"]


def test_bc_rl_entry_points_refuse_missing_cuda(monkeypatch):
    """BCTrainer, SACAgent, DiffusionBC / DiffusionQL, a zoo entry's init
    and EpisodeDataset.batches default to CUDA and raise without it."""
    from real_robot_nerf_actor_tpu_torch.data.demos import Trajectory
    from real_robot_nerf_actor_tpu_torch.data.episodes import EpisodeDataset
    from real_robot_nerf_actor_tpu_torch.models.representations import make_embedding
    from real_robot_nerf_actor_tpu_torch.rl import diffusion_bc, sac
    from real_robot_nerf_actor_tpu_torch.train import bc
    obs = np.zeros((8, 8, 3), np.float32)
    cloud = {"points": np.zeros((4, 3), np.float32), "colors": np.zeros((4, 3), np.float32)}
    tr = Trajectory([cloud] * 3, [np.zeros(4)] * 3, [0.0] * 3, [1.0, 0.0, 0.0],
                    [np.zeros(3)] * 3, True)
    ds = EpisodeDataset([tr], (-1, -1, -1, 1, 1, 1), voxel_size=10, max_num_coords=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: bc.BCTrainer(bc.BCConfig(), obs),
                 lambda: sac.SACAgent(sac.SACConfig(obs_type="image"), obs),
                 lambda: diffusion_bc.DiffusionBC(diffusion_bc.DiffusionBCConfig()),
                 lambda: diffusion_bc.DiffusionQL(diffusion_bc.DiffusionQLConfig()),
                 lambda: make_embedding("simple").init(obs[None]),
                 lambda: next(ds.batches())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_bc_rl_modules_run_without_jax(tmp_path):
    """In a process where jax, flax, optax and the JAX package cannot be
    imported: every module of the BC / RL slice imports, and a BC update,
    a SAC update, a DiffusionQL update and an episode round trip run on
    the CPU."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import real_robot_nerf_actor_tpu_torch.models.clip_visual\n"
        "import real_robot_nerf_actor_tpu_torch.models.pointnet2\n"
        "import real_robot_nerf_actor_tpu_torch.models.resnet\n"
        "from real_robot_nerf_actor_tpu_torch.data import episodes\n"
        "from real_robot_nerf_actor_tpu_torch.data.demos import Trajectory\n"
        "from real_robot_nerf_actor_tpu_torch.rl import (PrioritizedReplayBuffer, SACAgent,\n"
        "    SACConfig, diffusion_bc)\n"
        "from real_robot_nerf_actor_tpu_torch.train import bc\n"
        "rng = np.random.default_rng(0)\n"
        "img = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)\n"
        "tr = bc.BCTrainer(bc.BCConfig(embedding='resnet18', hidden_dim=8), img[0], device='cpu')\n"
        "assert np.isfinite(tr.update(img, rng.uniform(-1, 1, (4, 4))))\n"
        "ag = SACAgent(SACConfig(obs_type='image', hidden_dim=8), img[0], device='cpu')\n"
        "buf = PrioritizedReplayBuffer(8, (16, 16, 3), 4)\n"
        "for i in range(8):\n"
        "    buf.add(img[i % 4], rng.uniform(-1, 1, 4), 1.0, img[(i + 1) % 4], False)\n"
        "assert np.isfinite(ag.update(buf.sample(4))['actor_loss'])\n"
        "ql = diffusion_bc.DiffusionQL(diffusion_bc.DiffusionQLConfig(hidden_dim=8,\n"
        "    n_timesteps=5), device='cpu')\n"
        "o = rng.standard_normal((4, 7))\n"
        "m = ql.update_ql(o, rng.uniform(-1, 1, (4, 4)), o, np.ones(4), np.ones(4))\n"
        "assert all(np.isfinite(v) for v in m.values())\n"
        "cl = {'points': np.zeros((6, 3), np.float32), 'colors': np.zeros((6, 3), np.float32)}\n"
        "t = Trajectory([cl] * 3, [np.zeros(4)] * 3, [0.0] * 3, [1.0, 0.0, 0.0],\n"
        "               [np.zeros(3)] * 3, True)\n"
        "episodes.save_trajectory(sys.argv[1] + '/e.npz', t)\n"
        "ds = episodes.EpisodeDataset(sys.argv[1], (-1, -1, -1, 1, 1, 1), voxel_size=10,\n"
        "                             max_num_coords=8)\n"
        "assert next(ds.batches(2, device='cpu'))['points'].shape == (2, 8, 3)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_has_a_bc_phase():
    """chip_smoke.py's phase 10 runs the BC / RL slice at its stated sizes:
    BCConfig's batch, the zoo's full-width encoders, SAC's default image
    encoder, and the PerAct step of configs/peract.yaml."""
    import importlib.util
    import inspect
    from real_robot_nerf_actor_tpu_torch.train.bc import BCConfig
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = inspect.getsource(cs.bc_phase)
    for name in ('"resnet50"', '"dino"', '"mvp"', '"featurenerf"', '"pointnet2"',
                 "featurenerf_encoder_variables(", "update_ql(", "sample_action(",
                 "PrioritizedReplayBuffer(", "save_trajectory(", "EpisodeDataset(",
                 'conv_backend="pallas"', "extract_clip_features(", "statistics_frozen",
                 '"tf32"', "actor_gradient_in_encoder", "vjp_scaled"):
        assert name in src, name
    assert "bc_phase(" in inspect.getsource(cs.main)
    assert cs.BC_BATCH == BCConfig().batch_size and cs.BC_HW == 224
    assert (cs.SAC_BATCH, cs.SAC_HW) == (128, 64)


def test_teacher_panels_and_field_modes_run_without_jax_msgpack_or_matplotlib(tmp_path):
    """In a process where jax, flax, the JAX package, msgpack, matplotlib and
    PIL cannot be imported: read the committed JAX teacher, convert it and
    run its feature maps; write a render panel and a voxel view; run
    ConvEncoder, ImplicitNet, the quantized ResnetFC and the proposal field."""
    import subprocess
    import sys
    blocked = FORBIDDEN + ("msgpack", "matplotlib", "PIL")
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {blocked!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "from real_robot_nerf_actor_tpu_torch.train import teacher\n"
        "from real_robot_nerf_actor_tpu_torch.utils import visualize\n"
        "from real_robot_nerf_actor_tpu_torch.models.encoder2d import ConvEncoder\n"
        "from real_robot_nerf_actor_tpu_torch.models.implicit import ImplicitNet\n"
        "from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, VoxelNerfField\n"
        "from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights\n"
        "tr = teacher.TeacherTrainer(teacher.TeacherConfig(), device='cpu')\n"
        "st = teacher.load_teacher_state('artifacts/round5_featurenerf/teacher.msgpack',\n"
        "                                tr.init_state())\n"
        "f, a = tr.feature_maps(st, np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)))\n"
        "assert f.shape == (2, 16, 16, 64) and st.step == 3000\n"
        "root = sys.argv[1]\n"
        "img = visualize.save_render_panel(root + '/p.png', np.zeros((4, 5, 3)),\n"
        "    np.ones((4, 5, 3)), depth=np.ones((4, 5)), psnr=3.0)\n"
        "g = np.zeros((8, 8, 8, 10), np.float32); g[2, 3, 4, -1] = 1\n"
        "v = visualize.visualize_voxel_grid(g, np.array([1, 1, 1]), save_path=root + '/v.png')\n"
        "assert img.shape == (4, 19, 3) and v.shape[0] == 256\n"
        "with torch.no_grad():\n"
        "    assert init_weights(ConvEncoder(first_channels=8, mid_channels=8,\n"
        "        last_channels=4))(torch.rand(1, 128, 128, 3)).shape == (1, 128, 128, 4)\n"
        "    assert init_weights(ImplicitNet(d_in=3, dims=[8, 8]))(\n"
        "        torch.rand(5, 3)).shape == (5, 4)\n"
        "    for kw in (dict(quantized=True), dict(use_proposal=True)):\n"
        "        fld = init_weights(VoxelNerfField(NerfFieldConfig(d_latent=4, d_embed=3,\n"
        "            d_hidden=16, n_blocks=2, combine_layer=1, **kw)))\n"
        "        out = fld(torch.rand(1, 3, 3, 3, 4), torch.rand(1, 20, 3) * 0.5,\n"
        "                  torch.rand(1, 20, 3))\n"
        "        assert torch.isfinite(out['sigma']).all()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_teacher_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import (
        load_scene, save_scene, synthesize_scene_npz)
    from real_robot_nerf_actor_tpu_torch.train import teacher
    path = str(tmp_path / "s.npz")
    synthesize_scene_npz(path, n_views=2, hw=(8, 8))
    sc = load_scene(path)
    sc.depth = np.ones((2, 8, 8), np.float32)
    save_scene(path, sc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: teacher.TeacherTrainer(teacher.TeacherConfig()),
                 lambda: teacher.main(["--data-root", str(tmp_path), "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_chip_smoke_has_a_teacher_phase_and_the_field_modes():
    """chip_smoke.py drives the slice: phase 11 (the committed JAX teacher,
    the first-step check with its two planted faults, TEACHER_STEPS steps,
    the CLI's dump, the FeatureNeRF step, the novel-view panels, the two
    models), the proposal and quantized frames of phase 4 and the
    proposal joint step of phase 7 with its planted fault."""
    import importlib.util
    import inspect
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = inspect.getsource(cs.teacher_phase)
    for needle in ("load_teacher_state(", "teacher.fit(", "teacher.main(", "novel.main(",
                   '"uv_x_y_swapped"', '"temperature_dropped"', "ConvEncoder(",
                   "ImplicitNet(", "read_png("):
        assert needle in src, needle
    assert cs.TEACHER_STEPS == 1000 and (REPO / cs.TEACHER_MSGPACK).is_file()
    assert cs.TEACHER_SCENES == dict(n_scenes=8, n_views=12, hw=(128, 128))
    assert "teacher_phase(" in inspect.getsource(cs.main)
    assert "proposal_and_quantized_frames(" in inspect.getsource(cs.render_phase)
    assert "coarse_embed_fault=True" in inspect.getsource(cs.nerfact_phase)


def test_camera_and_aux_modules_run_without_jax():
    """In a process where jax, flax and the JAX package cannot be imported:
    every module of slice 10 imports, the package exports reach the JAX
    package's names, and the camera act path, an augmentation, a CNN head,
    a VL block, the deep UNet and a profiled step run on the CPU."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "from real_robot_nerf_actor_tpu_torch import compat\n"
        "from real_robot_nerf_actor_tpu_torch.data import augment, depth_filters\n"
        "from real_robot_nerf_actor_tpu_torch.data.synthetic import (camera_extrinsic,\n"
        "    camera_frames, make_synthetic_scene)\n"
        "from real_robot_nerf_actor_tpu_torch.models import MultiLayer3DEncoder, PerceiverConfig\n"
        "from real_robot_nerf_actor_tpu_torch.models import PerceiverIO\n"
        "from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights\n"
        "from real_robot_nerf_actor_tpu_torch.models.cnn_policies import CNNLangAndFcsNet\n"
        "from real_robot_nerf_actor_tpu_torch.models.vl_attention import Visual3DLangTransformer\n"
        "from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec, grid_sample_3d\n"
        "from real_robot_nerf_actor_tpu_torch.ops.grid_sample import grid_sample_3d_fastbwd\n"
        "from real_robot_nerf_actor_tpu_torch.tools import profile_policy\n"
        "from real_robot_nerf_actor_tpu_torch.train.serve import CameraActor, PolicyServer, ServeConfig\n"
        "from real_robot_nerf_actor_tpu_torch.utils import StepTimer, named_scope\n"
        "from real_robot_nerf_actor_tpu_torch.utils.cache import enable_persistent_cache\n"
        "K = np.array([[61.5, 0, 32], [0, 61.5, 24], [0, 0, 1]])\n"
        "sc = make_synthetic_scene(seed=0, n_points=20000)\n"
        "depth, rgb = camera_frames(sc, K, camera_extrinsic(), (48, 64), n_frames=2)\n"
        "cfg = PerceiverConfig(depth=1, voxel_size=10, num_latents=8, latent_dim=16,\n"
        "    lang_emb_dim=8, lang_max_seq_len=2)\n"
        "net = PerceiverIO.initialized(cfg, torch.Generator().manual_seed(0))\n"
        "srv = PolicyServer(ServeConfig(), cfg, VoxelizerSpec(10, 3, 500), net.state_dict(),\n"
        "    np.zeros((2, 8), np.float32), device='cpu')\n"
        "actor = CameraActor(srv, K, camera_extrinsic())\n"
        "acts = [actor.act(d, rgb, np.zeros(3), np.zeros(3), 1.0) for d in depth]\n"
        "assert all(np.isfinite(a[0]).all() for a in acts) and actor.last_num_points > 0\n"
        "x = torch.rand(2, 8, 8, 3)\n"
        "assert augment.random_shift(x, 2, generator=torch.Generator()).shape == x.shape\n"
        "with torch.no_grad(), StepTimer() as t, named_scope('aux'):\n"
        "    h = init_weights(CNNLangAndFcsNet(3, (8, 8), 4, 6))(x, torch.zeros(2, 4), torch.zeros(2, 6))\n"
        "    v = init_weights(Visual3DLangTransformer(8, 6, n_heads=2, d_head=4))(\n"
        "        torch.rand(1, 5, 8), torch.rand(1, 3, 6))\n"
        "    u, vl = init_weights(MultiLayer3DEncoder(4, 8))(torch.rand(1, 8, 8, 8, 4))\n"
        "assert h.shape == (2, 8) and v.shape == (1, 5, 8) and len(vl) == 3\n"
        "assert u.shape == (1, 8, 8, 8, 8) and t.seconds > 0\n"
        "g = torch.rand(1, 4, 4, 4, 2, requires_grad=True)\n"
        "grid_sample_3d_fastbwd(g, torch.rand(1, 9, 3) * 2 - 1).sum().backward()\n"
        "assert g.grad is not None and profile_policy.op_class('sm90_xmma_gemm') == 'gemm'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_camera_entry_points_refuse_missing_cuda(monkeypatch):
    from real_robot_nerf_actor_tpu_torch import compat
    from real_robot_nerf_actor_tpu_torch.data.depth_filters import depth_to_pointcloud
    from real_robot_nerf_actor_tpu_torch.tools import profile_policy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: compat.VoxelGrid((0, 0, 0, 1, 1, 1), 10),
                 lambda: depth_to_pointcloud(np.ones((4, 5), np.float32), np.eye(3), "cuda"),
                 lambda: compat.gen_rays(np.eye(4)[None], 4, 3, 2.0, 0.5, 2.0),
                 lambda: compat.choose_highest_action(np.zeros((1, 1, 2, 2, 2)),
                                                      np.zeros((1, 3 * 72 + 2)),
                                                      np.zeros((1, 2))),
                 lambda: profile_policy.main(["--n-inner", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_package_exports_reach_the_jax_packages_names():
    """Each name the JAX package's sub-package __init__s export (the import
    lists of their __init__ files, read without importing JAX) imports from
    the port's counterpart."""
    import importlib
    for sub in ("ops", "utils", "data", "models"):
        src = REPO / "real_robot_nerf_actor_tpu" / sub / "__init__.py"
        names = [a.name for node in ast.walk(ast.parse(src.read_text()))
                 if isinstance(node, ast.ImportFrom) for a in node.names]
        assert names, sub
        port = importlib.import_module(f"real_robot_nerf_actor_tpu_torch.{sub}")
        for name in names:
            assert hasattr(port, name), f"{sub}.{name}"
            assert name in port.__all__, f"{sub}.{name} not in __all__"


def test_chip_smoke_has_a_camera_phase():
    """chip_smoke.py's phase 12 drives the camera act path at full width
    (480 x 640 frames, serve.yaml's policy with the kernels on) and the
    slice's models, ops and tools, with its planted faults."""
    import importlib.util
    import inspect
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = inspect.getsource(cs.camera_phase)
    for needle in ("CameraActor(", "DepthFilterPipeline(", "depth_to_pointcloud(",
                   "transform_points(", "euler_to_quaternion(", "compat.VoxelGrid(",
                   "compat.choose_highest_action(", "extrinsic_transposed=",
                   "CNNLangAndFcsNet(", "CNNAndFcsNet(", "SiameseNet(", "SpatialSoftmax2D(",
                   "Visual3DLangTransformer(", "LanguageInformedVisualAttention(",
                   "MultiLayer3DEncoder(", "planted_symmetric_padding", "planted_exact_gelu",
                   "planted_tf32", "fp32_check(", "VOXEL_DIFF",
                   "random_shift(", "color_jitter(", "random_grayscale(",
                   "grid_sample_3d_fastbwd(", "composite_unsorted(", "profile_policy.main(",
                   "enable_persistent_cache("):
        assert needle in src, needle
    assert "camera_phase(" in inspect.getsource(cs.main)
    assert cs.CAMERA == dict(hw=(480, 640), frames=8, n_points=2000000)
    assert cs.CAMERA_MODELS["batch"] == 64 and cs.CAMERA_MODELS["hw"] == (128, 128)
    assert cs.CAMERA_MODELS["lang_dim"] == 512
    assert cs.CAMERA_MODELS["vl_tokens"] == (8000, 128) and cs.CAMERA_MODELS["lang_tokens"] == 77
    assert cs.FASTBWD == dict(grid=(1, 100, 100, 100, 64), samples=49152)
    assert cs.COMPOSITE == dict(rays=512, samples=96)


def test_profile_policy_runs_serve_yaml():
    """tools/profile_policy.py's policy is configs/serve.yaml's (the card
    has no PyYAML), and its trace reader sums the device lanes by class."""
    import json
    import yaml
    from real_robot_nerf_actor_tpu_torch.tools import profile_policy
    with open(REPO / "configs" / "serve.yaml") as f:
        assert yaml.safe_load(f)["peract"]["model"] == profile_policy.SERVE_POLICY
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "flash_attention_wgmma_kernel", "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "dur": 1000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5000}]}
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(trace, f)
    total, by_class, by_name = profile_policy.aggregate_trace(f.name)
    assert total == 1.25 and by_class == {"flash_attention": 0.2, "gemm": 1.0, "copy": 0.05}
    assert set(by_name) == {"flash_attention_wgmma_kernel", "sm90_xmma_gemm_bf16", "Memcpy HtoD"}


def test_package_imports_without_mujoco_or_gymnasium():
    """In a process where mujoco, gymnasium, jax, flax, optax and the JAX
    package cannot be imported: every module of the port but `envs/`
    imports (the env half of data/demos.py imports MuJoCo when called,
    and then raises ImportError naming it), and so does chip_smoke.py."""
    import subprocess
    import sys
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN + ('mujoco', 'gymnasium')!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import real_robot_nerf_actor_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')\n"
        "         if '.envs' not in m.name]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from real_robot_nerf_actor_tpu_torch.data import demos\n"
        "try:\n"
        "    demos.generate_nerf_scene('lift', n_views=1, image_size=4)\n"
        "except ImportError as e:\n"
        "    assert 'mujoco' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('generate_nerf_scene ran without mujoco')\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 100


def test_env_modules_import_nothing_of_jax():
    """The envs, the env half of data/demos.py and the new tools keep their
    own copies of the MJCF, the tasks and the expert: no import of jax,
    flax or the JAX package, even of its env modules (which import no
    JAX)."""
    files = sorted((PORT / "envs").glob("*.py")) + [
        PORT / "data" / "demos.py", PORT / "tools" / "gen_data.py",
        PORT / "tools" / "train_rl.py", PORT / "tools" / "grad_forensics.py"]
    assert len(files) == 9
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, f"{f.relative_to(REPO)} imports {name}"


def test_chip_smoke_has_an_envs_forensics_phase():
    """chip_smoke.py's phase 15 drives the fixture's episodes and scenes and
    tools/grad_forensics.py at full width with its checks and planted
    faults; its planted weights are parameters of the joint step."""
    import dataclasses
    import importlib.util
    import inspect

    from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = inspect.getsource(cs.envs_forensics_phase)
    for needle in ("gen_data.npz_digest(", "sac_on_live_pixels(", "EpisodeDataset(",
                   "final_conv_as_plain(", '"vjp_scaled"', '"bias_scaled"', "F64_VOXELS",
                   "dump_teacher_features(", "featurenerf_first_step_check(",
                   "write_multi_kitchen_dataset(", "nerfact.main(", "deterministic_algorithms(",
                   '"--mode", "replay"', '"dissect"', '"probe"', '"mint"', "kernel_counts(",
                   "FIELD_FAULT", "ATTN_FAULT", 'mujoco="present" if present else "absent"'):
        assert needle in src, needle
    assert "envs_forensics_phase(" in inspect.getsource(cs.main)
    assert (REPO / cs.FIXTURE_DIR / "manifest.json").is_file()
    assert cs.FORENSICS_DATA["image_hw"] == (128, 128) and cs.FORENSICS_DATA["d_embed"] == 512
    assert cs.FORENSICS_MID < cs.FORENSICS_STEPS
    tr = NerfActTrainer(NerfActConfig(peract=dataclasses.replace(
        NerfActConfig().peract, model=PerceiverConfig(
            depth=3, voxel_size=10, num_latents=8, latent_dim=16, input_encoder="unet",
            return_voxel_feat=True))), device="cpu")
    sd = tr.init_state(torch.Generator().manual_seed(0)).module.state_dict()
    for name, index in (cs.FIELD_FAULT, cs.ATTN_FAULT):
        assert sd[name][index].numel() == 1, name
