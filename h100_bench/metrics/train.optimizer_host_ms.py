"""train.optimizer_host_ms: the median host ms of a `train_step.optimizer`
span (the non-finite flag's wait and AdamW's launches) in the CUDA-only
traced window."""
from h100_bench.core import spans


def read(ctx):
    w = spans.window(ctx, "train_step")
    return None if w is None else spans.median_ms(w, "train_step.optimizer")
