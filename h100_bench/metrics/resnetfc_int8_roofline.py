"""resnetfc_int8_roofline: 100 x the least time of the fused_resnetfc_int8
launches in the traced window (their operations at their dtypes' peaks, or
their bytes at the memory's peak) over their device time."""


def read(ctx):
    return ctx.roofline("fused_resnetfc_int8")
