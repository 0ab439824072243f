"""The four hand-written kernel families' share of their roofline, in %:
the least time of the bytes their calls need (inputs read once, outputs
written once, counted from what the step does) at the HBM rate, over the
device time of their kernels in the traced window."""

from benchmark.harness.work import FAMILIES_RX, PEAK_HBM_BYTES_S


def read(ctx):
    s = ctx.trace.kernel_s(FAMILIES_RX)
    if s <= 0 or not ctx.work.get("kernel_bytes"):
        return None
    return 100.0 * ctx.work["kernel_bytes"] / PEAK_HBM_BYTES_S / s
