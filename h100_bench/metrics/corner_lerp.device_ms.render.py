"""corner_lerp.device_ms.render: device ms a unit of the corner_lerp kernel's
launches. (A share of its roofline is not read: the gathered rows it reads
were written just before and come from L2, so its time undercuts the HBM
bound, 108-129 % of it on the H100.)"""


def read(ctx):
    return ctx.kernel_ms("corner_lerp")
