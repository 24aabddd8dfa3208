"""train.unet_conv_backward_ms: device ms a step of the kernels launched inside the
program's host range `backward.unet_conv`, the backward of the policy UNet's convs (their
data gradients, weight gradients and bias sums); None where the program opens no such
range."""


def read(ctx):
    return ctx.range_ms("backward.unet_conv")
