"""Kernel launches on the device a fit step: the profiler's kernels in the
window over the steps the window's fits computed."""


def read(ctx):
    steps = ctx.work.get("steps", 0)
    return len(ctx.trace.kernels) / steps if ctx.trace and ctx.trace.kernels and steps else None
