"""conv3d_k3_roofline: 100 x the least time of the conv3d_k3 launches in the
traced window (their operations at their dtypes' peaks, or their bytes at
the memory's peak) over their device time."""


def read(ctx):
    return ctx.roofline("conv3d_k3")
