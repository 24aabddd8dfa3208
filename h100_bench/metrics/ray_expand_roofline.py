"""ray_expand_roofline: 100 x the least time of the ray_expand launches in the
traced window (their operations at their dtypes' peaks, or their bytes at
the memory's peak) over their device time."""


def read(ctx):
    return ctx.roofline("ray_expand")
