"""Fixtures of the benchmark's tests: a copy of the benchmark at a tiny width
(every configuration's widths, the traffic's sizes cut down) that runs on the
CPU on the port's plain paths, and the card's presence, decided inside a
fixture."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = dict(voxel_size=20, num_latents=8, latent_dim=32, depth=1, latent_heads=2,
                  latent_dim_head=8, cross_dim_head=8)
TINY_FIELD = dict(d_hidden=32, d_embed=16, n_blocks=2, combine_layer=1)
TINY_TRAFFIC = {
    "nerfact.train": dict(pool=4, points=[200, 400], pad_to=600, view=[8, 8], focal=7.6),
    "serve.render.cam480": dict(frame=[12, 16], focal=15.2, poses=2, cloud_points=400,
                                pad_to=600, warmup_frames=1, check_every=2, checked_frames=2,
                                embed_stride=2)}


def make_tiny_root(dest: Path) -> Path:
    """A checkout of BENCHMARK.json and h100_bench/ at `dest`, cut to a tiny
    width for the CPU."""
    shutil.copytree(REPO / "h100_bench", dest / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for p in (dest / "h100_bench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        prog = c["program"]
        prog["peract"]["model"].update(TINY_MODEL)
        prog["peract"]["voxelizer"].update(voxel_size=20, max_num_coords=600)
        r = prog["renderer"]
        r.update(image_width=8, image_height=8, ray_chunk_size=16)
        if r["n_coarse"] > 16:
            r.update(n_coarse=8, n_fine=4, n_fine_depth=2)
        r["field"].update(TINY_FIELD)
        p.write_text(json.dumps(c))
    for name, cut in TINY_TRAFFIC.items():
        p = dest / "h100_bench" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(cut)
        p.write_text(json.dumps(t))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)
