"""render.field_host_ms: host ms a tile in `render.field` spans (each pass's
`_eval_points`: ray_expand, the gather, corner_lerp and the MLP launch),
summed over the CUDA-only traced window's tiles and divided by their
number."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "render.frame")
    if w is None:
        return None
    return sum(w.ms(w.below("render.field"))) / spans.count(w, "render.tile")
