"""Kernel launches on the device a gradient of the log-density: the
profiler's kernels in the window over the gradient evaluations that the
sampler's results report."""


def read(ctx):
    grads = ctx.work.get("grads", 0)
    return len(ctx.trace.kernels) / grads if ctx.trace and ctx.trace.kernels and grads else None
