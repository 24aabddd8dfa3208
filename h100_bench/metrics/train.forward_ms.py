"""train.forward_ms: device ms a step of the kernels launched inside the program's host
range `train_step.forward`."""


def read(ctx):
    return ctx.range_ms("train_step.forward")
