"""Device ms a step of the NCCL kernels on rank 0 in the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s(r"(?i)nccl")
    if s <= 0 or not ctx.work.get("steps"):
        return None
    return 1e3 * s / ctx.work["steps"]
