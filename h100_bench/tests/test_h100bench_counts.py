"""Operation and byte counts against hand-worked shapes."""
from __future__ import annotations

import pytest
import torch

from h100_bench.core import counts
from h100_bench.core.peaks import PEAK_BYTES_PER_S, PEAK_OPS_PER_S, least_seconds


def test_final_conv_at_100_cubed():
    ops, nbytes = counts.conv3d_k3(1, 100, 100, 100, 128, 64)
    assert ops == {"bfloat16": 4.42368e11}
    assert nbytes == 10 ** 6 * 128 * 2 + 27 * 128 * 64 * 2 + 64 * 4 + 10 ** 6 * 64 * 2
    # the kernel table's bound: 0.447 ms, by operations
    assert least_seconds(ops, nbytes) * 1e3 == pytest.approx(0.4473, abs=1e-4)


def test_corner_lerp_and_ray_expand():
    ops, nbytes = counts.corner_lerp(32768, 64)
    assert ops == {"float32": 16 * 32768 * 64}
    assert nbytes == 32768 * (1024 + 32 + 128)
    ops, nbytes = counts.ray_expand(4096, 16)
    n = 4096 * 16
    assert ops == {"float32": 120 * n}
    assert nbytes == 4096 * 32 + n * 4 + n * (24 * 2 + 36)


def test_int8_field_per_row():
    ops, nbytes = counts.resnetfc_int8(1)
    # the kernel table: 5.24 M int8 operations and 0.29 M bf16 flops a row
    assert ops["int8"] == 2 * 5 * 2 * 512 * 512 == 5242880
    assert ops["bfloat16"] == 2 * 512 * (80 + 3 * 64 + 8) == 286720
    w = 512 * 80 * 2 + 512 * 4 + 3 * 512 * 64 * 2 + 3 * 512 * 4 + 10 * 512 * 512 \
        + 2 * 10 * 512 * 4 + 8 * 512 * 2 + 32
    assert nbytes == 128 * 2 + w + (128 + 512) * 2
    big = counts.resnetfc_int8(65536)
    t = least_seconds(*big)
    assert t == pytest.approx(65536 * (5242880 / PEAK_OPS_PER_S["int8"]
                                       + 286720 / PEAK_OPS_PER_S["bfloat16"]))


def test_least_time_takes_the_larger_bound():
    assert least_seconds({"float32": 67e12}, 0) == pytest.approx(1.0)
    assert least_seconds({"float32": 1.0}, PEAK_BYTES_PER_S) == pytest.approx(1.0)


def test_model_ops_count_products_by_dtype_on_meta():
    a = torch.zeros((64, 32), device="meta", dtype=torch.bfloat16)
    b = torch.zeros((32, 16), device="meta", dtype=torch.bfloat16)
    x = torch.zeros((1, 3, 8, 8, 8), device="meta")
    w = torch.zeros((4, 3, 3, 3, 3), device="meta")

    def run():
        a @ b
        torch.nn.functional.conv3d(x, w, padding=1)
    ops = counts.model_ops(run)
    assert ops["bfloat16"] == 2 * 64 * 32 * 16
    assert ops["float32"] == 2 * 512 * 4 * 3 * 27
