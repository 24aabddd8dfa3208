"""featurenerf.host_syncs_per_step: the CUDA-only traced window's copies that
the host waits for (`Memcpy HtoD (Pageable ...` and `Memcpy DtoH`) over the
window's steps, one a unit."""
from h100_bench.core import spans


def read(ctx):
    return spans.sync_ops(ctx) / len(ctx.units) if ctx.trace.on_device else None
