"""render.launches_per_tile: every device op of the CUDA-only traced window
(kernels, copies, sets) over the window's `render.tile` spans."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "render.frame")
    return None if w is None else spans.device_ops(ctx) / spans.count(w, "render.tile")
