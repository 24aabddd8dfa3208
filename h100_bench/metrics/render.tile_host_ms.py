"""render.tile_host_ms: the median host ms of a `render.tile` span (one
tile's coarse and fine pass, launches to return) in the CUDA-only traced
window."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "render.frame")
    return None if w is None else spans.median_ms(w, "render.tile")
