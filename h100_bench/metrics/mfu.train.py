"""mfu.train: 100 x the window's model operations, each at the peak of its
dtype, over the window's length."""


def read(ctx):
    return ctx.mfu()
