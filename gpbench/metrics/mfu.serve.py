"""The whole request's share of the card's float32 peak: the FLOPs that the
window's requests need by the configuration's ``serve_request_flops``
(``yardstick/flops/<configuration>.py``), over the
window's seconds times 67 TFLOP/s."""

from gpbench.yardstick.peaks import PEAK_FP32_S


def read(ctx):
    count = getattr(ctx.flops, "serve_request_flops", None)
    units = ctx.work.get("requests", 0)
    if count is None or not units or ctx.elapsed <= 0:
        return None
    flops = units * count(ctx.cfg, int(ctx.traffic["points_per_request"]))
    return 100.0 * flops / (ctx.elapsed * PEAK_FP32_S)
