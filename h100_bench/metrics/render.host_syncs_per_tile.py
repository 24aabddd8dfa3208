"""render.host_syncs_per_tile: the CUDA-only traced window's copies that the
host waits for (`Memcpy HtoD (Pageable ...` and `Memcpy DtoH`) over its
`render.tile` spans."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "render.frame")
    return None if w is None else spans.sync_ops(ctx) / spans.count(w, "render.tile")
