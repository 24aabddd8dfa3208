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
