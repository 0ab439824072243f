"""The devices' idle share of the traced window, in %: 1 - the union of
the device events (kernels, copies, sets) over the window's host-clock
length, the busy time averaged over the cards the run uses
(``ctx.work["busy_s"]``)."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.work["busy_s"] / ctx.trace.window_s)
