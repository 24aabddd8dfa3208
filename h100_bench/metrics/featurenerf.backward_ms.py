"""featurenerf.backward_ms: device ms a step of the kernels launched inside the program's
host range `featurenerf.backward` (None where the program opens no such range)."""


def read(ctx):
    return ctx.range_ms("featurenerf.backward")
