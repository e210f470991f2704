"""The sampler's share of the card's float32 peak: the FLOPs of the
window's gradients of the log-density, all chains a gradient, by
the configuration's ``hmc_gradient_flops``
(``yardstick/flops/<configuration>.py``), over the window's seconds times 67
TFLOP/s."""

from gpbench.yardstick.peaks import PEAK_FP32_S


def read(ctx):
    count = getattr(ctx.flops, "hmc_gradient_flops", None)
    units = ctx.work.get("grads", 0)
    if count is None or not units or ctx.elapsed <= 0:
        return None
    flops = units * count(ctx.cfg, int(ctx.traffic["chains"]))
    return 100.0 * flops / (ctx.elapsed * PEAK_FP32_S)
