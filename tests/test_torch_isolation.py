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
