"""mfu.featurenerf: 100 x the window's model operations (the driver's
`model_ops`: the encoder's convs and resizes, the field's products, forward
and backward, both passes), each at the peak of its dtype (fp32: 67 TF/s),
over the window's length."""


def read(ctx):
    return ctx.mfu()
