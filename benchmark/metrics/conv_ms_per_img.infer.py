"""Device ms an image of the kernels that convolution operators launched,
forward and backward (the profiler's operator-to-kernel attribution)."""

from benchmark.harness.trace import op_device_s

CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def read(ctx):
    s = op_device_s(ctx.prof, CONV_OPS)
    if s <= 0 or not ctx.work.get("images"):
        return None
    return 1e3 * s / ctx.work["images"]
