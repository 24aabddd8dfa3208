"""The reader of `train.unet_conv_backward_ms` on hand-built traces: the device
seconds inside the program's `backward.unet_conv` ranges over the host window's
steps, None where the program opens no such range (a program without the span)
or where nothing ran on a device."""
from __future__ import annotations

import pytest

from h100_bench.core import manifest as mf
from h100_bench.core.trace import Trace
from h100_bench.core.window import LayerContext

NAME = "train.unet_conv_backward_ms"
# device seconds inside each host range, and the range's calls: 11 convs a step
RANGES = {"train_step.backward": (0.2, 2), "backward.unet_conv": (0.0132, 22)}


def _trace(ranges, on_device=True):
    return Trace(window_s=1.0, busy_s=0.5, kernels={}, ranges=dict(ranges), gaps=[],
                 on_device=on_device)


def _ctx(ranges, on_device=True, host_units=2):
    return LayerContext(_trace({}, on_device), None, [0, 1, 2], _trace(ranges, on_device),
                        list(range(host_units)))


@pytest.mark.parametrize("host_units", [1, 2, 4])
def test_reads_the_spans_device_ms_a_step(host_units):
    got = mf.load_reader(NAME)(_ctx(RANGES, host_units=host_units))
    assert got == pytest.approx(13.2 / host_units)


@pytest.mark.parametrize("ranges,on_device", [
    ({"train_step.backward": (0.2, 2)}, True),   # the parent: no such span
    (RANGES, False)])                            # nothing on a device
def test_reads_none_where_there_is_nothing_to_read(ranges, on_device):
    assert mf.load_reader(NAME)(_ctx(ranges, on_device)) is None


def test_the_manifest_lists_it_in_the_train_cell():
    entry = [m for m in mf.load_manifest()["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1
    assert entry[0]["workloads"] == ["nerfact.train"]
    assert entry[0]["moves"] == "train_samples_per_s" and entry[0]["layer"] == "policy"
