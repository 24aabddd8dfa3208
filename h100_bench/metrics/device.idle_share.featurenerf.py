"""device.idle_share.featurenerf: 100 x the share of the traced window in
which no operation ran on the device."""


def read(ctx):
    return ctx.idle_share()
