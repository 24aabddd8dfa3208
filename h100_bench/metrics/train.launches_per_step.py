"""train.launches_per_step: every device op of the CUDA-only traced window
(kernels, copies, sets) over its `train_step` spans, one a unit."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "train_step")
    return None if w is None else spans.device_ops(ctx) / len(w.units)
