"""A kernel's share of its roofline over a traced window: the summed least
time of the recorded calls of its public ops (``ops.op_work``,
``ops.bound_s``) over the device time of its kernels."""

from .ops import bound_s, op_work

PROGRAM = "fastgaussianprocesses_torch"
# the public kernel ops, in every module that calls them by name
PERM_FFT_CALLS = [(f"{PROGRAM}.ops.{mod}", op, op)
                  for mod, ops in (("perm_fft", ("pfft", "pifft_real", "pifft", "pfft_quad")),
                                   ("transforms", ("pfft", "pifft_real", "pifft")))
                  for op in ops]
PERM_FFT_KERNELS = ("pass_a_kernel", "pfft_slab_kernel", "pifft_slab_kernel", "quad_slab_kernel")
FWHT_CALLS = [(f"{PROGRAM}.ops.fwht", "fwht", "fwht"), (f"{PROGRAM}.ops.transforms", "fwht", "fwht")]
FWHT_KERNELS = ("fwht_kernel",)


def share_pct(ctx, ops, kernels):
    """Percent of the roofline, or None where the window ran none of them."""
    bound = sum(bound_s(*op_work(op, shapes, cplx))[0]
                for op, shapes, cplx in ctx.records if op in ops)
    device = ctx.trace.kernel_s(kernels) if ctx.trace else 0.0
    if not (bound > 0 and device > 0):
        return None
    return 100.0 * bound / device
