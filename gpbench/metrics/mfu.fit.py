"""The whole fit step's share of the card's float32 peak: the FLOPs of the
window's steps by the configuration's ``fit_step_flops``
(``yardstick/flops/<configuration>.py``), over the window's
seconds times 67 TFLOP/s."""

from gpbench.yardstick.peaks import PEAK_FP32_S


def read(ctx):
    count = getattr(ctx.flops, "fit_step_flops", None)
    units = ctx.work.get("steps", 0)
    if count is None or not units or ctx.elapsed <= 0:
        return None
    return 100.0 * units * count(ctx.cfg) / (ctx.elapsed * PEAK_FP32_S)
