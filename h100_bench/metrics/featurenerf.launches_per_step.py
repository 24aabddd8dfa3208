"""featurenerf.launches_per_step: every device op of the CUDA-only traced
window (kernels, copies, sets) over the window's steps, one a unit."""
from h100_bench.core import spans


def read(ctx):
    return spans.device_ops(ctx) / len(ctx.units) if ctx.trace.on_device else None
