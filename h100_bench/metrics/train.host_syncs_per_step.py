"""train.host_syncs_per_step: the CUDA-only traced window's copies that the
host waits for (`Memcpy HtoD (Pageable ...` and `Memcpy DtoH`) over its
`train_step` spans, one a unit."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "train_step")
    return None if w is None else spans.sync_ops(ctx) / len(w.units)
