"""K4 (``ops/fwht``, ``csrc/fwht.cu``) against its roofline over the fit
window: the bound of every call of ``fwht`` (R n (log2 n + 1) FLOPs, rows
read and written once) over ``fwht_kernel``'s device time."""

from gpbench.yardstick.roofline import FWHT_CALLS, FWHT_KERNELS, share_pct

CALLS = FWHT_CALLS


def read(ctx):
    return share_pct(ctx, {"fwht"}, FWHT_KERNELS)
