"""Routing of the fused ResnetFC between its two CUDA kernel designs
(`ops/resnetfc_cuda.mlp_design`): the wgmma/TMA kernel for int8 block
products at d_hidden 256 or 512, the first (mma.sync) kernel for the rest.
The gate is plain Python, so it runs here, as does the host-side weight
layout the wgmma kernel's ring copies (`ring_layout`); the kernels
themselves run in tests/test_torch_kernels_cuda.py on a card."""
from pathlib import Path

import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu_torch.ops import resnetfc_cuda as rf

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("quantized,d_hidden,k_in,k_lat,want", [
    (True, 512, 80, 64, "wgmma"),       # configs/serve.yaml's field
    (True, 256, 80, 64, "wgmma"),
    (True, 512, 112, 16, "wgmma"),
    (False, 512, 80, 64, "mma_sync"),   # mlp_backend "pallas_bf16"
    (False, 256, 80, 64, "mma_sync"),
    (True, 384, 80, 64, "mma_sync"),    # not a multiple of 256
    (True, 32, 80, 16, "mma_sync"),
    (True, 512, 128, 64, "mma_sync"),   # the aux input outgrows its buffer
    (True, 512, 80, 80, "mma_sync"),    # the latent lanes outgrow theirs
])
def test_mlp_design_gate(quantized, d_hidden, k_in, k_lat, want):
    assert rf.mlp_design(quantized, d_hidden, k_in, k_lat) == want


def _serve_field():
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config
    return load_config(NerfActConfig, str(REPO / "configs/serve.yaml")).renderer.field


def _packed(field, quantize, seed=0):
    from real_robot_nerf_actor_tpu_torch.models import ResnetFC
    net = ResnetFC(d_in=3 + 6 * field.num_freqs + 3, d_out=4 + 32, n_blocks=field.n_blocks,
                   d_latent=field.d_latent, d_hidden=field.d_hidden,
                   combine_layer=field.combine_layer)
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g) * 0.05 for k, v in net.state_dict().items()}
    return rf.pack_resnetfc_params(sd, d_latent=field.d_latent, num_freqs=field.num_freqs,
                                   d_hidden=field.d_hidden, n_blocks=field.n_blocks,
                                   combine_layer=field.combine_layer, quantize=quantize)


@pytest.mark.parametrize("quantize,want", [(True, "wgmma"), (False, "mma_sync")])
def test_serve_yaml_field_routes(quantize, want):
    """The serve.yaml field as the renderer packs it (mlp_backend
    "pallas_int8" as written, and "pallas_bf16"): the int8 calls go to the
    wgmma kernel, the bf16 ones to the first kernel."""
    field = _serve_field()
    assert field.mlp_backend == "pallas_int8" and field.d_hidden == 512
    kp = _packed(field, quantize)["kernel"]
    assert (kp["k_in"], kp["k_lat"]) == (80, 64)
    assert rf.mlp_design(quantize, kp["b_in"].shape[0], kp["k_in"], kp["k_lat"]) == want


def _small_call(quantize):
    field = _serve_field()
    packed = _packed(field, quantize, seed=1)
    rng = np.random.default_rng(2)
    n = 70
    zi = rf.pack_mlp_input(torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32)),
                           torch.from_numpy(rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)),
                           torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)),
                           6, 1.5)
    return packed, zi


@pytest.mark.parametrize("design", [None, "wgmma", "mma_sync"])
def test_design_argument_on_cpu(design):
    """On a CPU tensor either design runs the plain version: the same
    outputs, no launch counted."""
    packed, zi = _small_call(True)
    counts = (rf.fused_resnetfc_int8.launches, rf.fused_resnetfc_int8.wgmma_launches)
    got = rf.fused_resnetfc_int8(zi, packed, design=design)
    want = rf.fused_resnetfc_int8_plain(zi, packed)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (rf.fused_resnetfc_int8.launches, rf.fused_resnetfc_int8.wgmma_launches) == counts


def test_design_argument_refuses_what_it_cannot_run():
    packed, zi = _small_call(False)
    with pytest.raises(ValueError, match="wgmma design does not take"):
        rf.fused_resnetfc_int8(zi, packed, quantized=False, design="wgmma")
    with pytest.raises(ValueError, match="one of"):
        rf.fused_resnetfc_int8(zi, packed, quantized=False, design="simt")
    aux = torch.zeros((24, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma design does not take"):
        rf.fused_gather_resnetfc_int8(torch.zeros((8, 512)), torch.zeros(64, dtype=torch.int32),
                                      torch.zeros((8, 64)), aux, packed, quantized=False,
                                      design="wgmma")


@pytest.mark.parametrize("m,n,k", [(2, 64, 64), (10, 512, 512), (4, 256, 256)])
def test_ring_layout_is_the_swizzled_slice_image(m, n, k):
    """Byte (n, 32 s + c) of matrix j sits where a 32-byte-swizzle TMA box of
    the slice would put it in shared memory, slices back to back in stream
    order: the wgmma kernel's bulk copies then fill its ring as the boxes
    did."""
    rng = np.random.default_rng(3)
    wq = torch.from_numpy(rng.integers(-127, 128, (m, n, k), dtype=np.int8))
    got = rf.ring_layout(wq).reshape(-1)
    j, row, col = np.meshgrid(np.arange(m), np.arange(n), np.arange(k), indexing="ij")
    s, c = col // 32, col % 32
    off = ((j * (k // 32) + s) * n + row) * 32 + (c ^ (16 * ((row >> 2) & 1)))
    want = torch.empty(m * n * k, dtype=torch.int8)
    want[torch.from_numpy(off.reshape(-1))] = wq.reshape(-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantize", [True, False])
def test_pack_adds_the_ring_layout_for_int8(quantize):
    kp = _packed(_serve_field(), quantize)["kernel"]
    if quantize:
        assert torch.equal(kp["wq_ring"], rf.ring_layout(kp["wq"]))
    else:
        assert "wq_ring" not in kp


def test_phase_tool_instruments_the_kernel():
    """tools/mlp_phases.py finds its anchors in csrc/resnetfc_int8.cu: a
    stamp at the start, after each of the 13 barrier and block-product sites,
    before the head and at the end, and room for every phase of the serve
    widths."""
    from real_robot_nerf_actor_tpu_torch.ops import _build
    from real_robot_nerf_actor_tpu_torch.tools import mlp_phases
    src = (_build.CSRC / "resnetfc_int8.cu").read_text()
    stamped = mlp_phases.stamped_source(src)
    assert stamped.count("STAMP();") == 16
    assert mlp_phases.WGMMA in src
    for dynamic in (False, True):
        assert len(mlp_phases.phase_labels(5, 3, dynamic)) + 1 <= 64
