"""All-reduce calls a step on rank 0 (an exact count of the host's
collective operators in the traced window, over the window's steps)."""

import re

ALL_REDUCE = re.compile(r"^c10d::allreduce_$")


def read(ctx):
    n = sum(1 for e in ctx.trace.host_ops if ALL_REDUCE.match(str(e["name"])))
    if not n or not ctx.work.get("steps"):
        return None
    return n / ctx.work["steps"]
