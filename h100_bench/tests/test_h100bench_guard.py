"""The import guard, and a reference that imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

from h100_bench.core.guard import forbidden_modules

from .conftest import REPO


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["real_robot_nerf_actor_tpu_torch.ops", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                              "real_robot_nerf_actor_tpu.models"]) == [
        "flax", "jax", "jaxlib", "real_robot_nerf_actor_tpu"]
    assert forbidden_modules(["jaxtyping", "flaxen"]) == []


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_and_every_driver_load_no_jax():
    top = _loaded("import h100_bench.run as r, h100_bench.core.window, h100_bench.core.trace\n"
                  "from h100_bench.core import manifest as mf\n"
                  "import h100_bench.tools.readings\n"
                  "for n in ('nerfact_train', 'serve_render'): mf.load_driver(n)\n"
                  "import real_robot_nerf_actor_tpu_torch.train.nerfact\n"
                  "import real_robot_nerf_actor_tpu_torch.render.renderer")
    assert not top & {"jax", "jaxlib", "flax", "real_robot_nerf_actor_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded("import h100_bench.reference.nerfact_train, h100_bench.reference.serve_render")
    assert "real_robot_nerf_actor_tpu_torch" not in top and "jax" not in top


def test_no_reference_source_names_the_port():
    for path in (REPO / "h100_bench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("real_robot_nerf_actor_tpu_torch", "jax",
                                               "flax", "real_robot_nerf_actor_tpu"), (path, n)
