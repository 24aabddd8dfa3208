"""Profiling helpers (counterpart of the JAX package's
`utils/profiling.py`): named trace ranges, a step timer that waits for the
device, and a `torch.profiler` trace of a block.

The reference's cut points (record_function scopes "renderer_composite",
"model_inference", "resnetfc_infer", ...) appear under the same names in a
`torch.profiler` trace; on CUDA the range is also an NVTX range, which an
external profiler of the card reads.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def named_scope(name: str):
    """A `torch.profiler.record_function` range, and an NVTX range on CUDA."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(tree) -> None:
    """Synchronise the CUDA device of every tensor in `tree` (a tensor, or
    dicts, lists and tuples of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock step timer that waits for the device before reading the
    clock: with StepTimer(sync_on=out) as t: ...; t.seconds. `sync_on` is a
    tensor or a tree of them (read when the block ends, so it may be filled
    inside it: pass a list and append to it)."""

    def __init__(self, sync_on: Optional[object] = None):
        self._sync_on = sync_on
        self.seconds = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_on is not None:
            _sync(self._sync_on)
        self.seconds = time.perf_counter() - self._start
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a `torch.profiler` trace (CPU, and CUDA where there is a card)
    of the block and write it into `log_dir` as a Chrome trace
    (`trace.json`). Yields the profiler, whose `key_averages()` the caller
    may read after the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
