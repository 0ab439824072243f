"""The whole step's share of the chip's peak, in %: the model FLOPs of the
work done in the traced window (the benchmark's own count of the reference
architecture: frozen forwards once, trained parts forward and backward,
nothing recomputed) over the window's length x the bfloat16 dense peak x
the chips."""

from benchmark.harness.work import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.work.get("flops"):
        return None
    return 100.0 * ctx.work["flops"] / (ctx.trace.window_s * PEAK_BF16_FLOPS
                                        * ctx.chips)
