"""The cross-kernel's share of the device's busy time: the device time of
the kernels launched inside a range around ``kernels/series.kernel_fused_scan``
(which ``models/fast.py`` calls through the module) over the window's busy
time."""

SPANS = [("fastgaussianprocesses_torch.kernels.series", "kernel_fused_scan",
          "gpbench.cross_kernel")]


def read(ctx):
    t = ctx.trace
    dev = t.span_device_s.get("gpbench.cross_kernel", 0.0) if t else 0.0
    return 100.0 * dev / t.busy_s if dev > 0 and t.busy_s > 0 else None
