"""K1-K3 (``ops/perm_fft``, ``csrc/perm_fft.cu``) against their roofline over
the sampler's window: the bound of every call of ``pfft``, ``pifft_real``,
``pifft`` and ``pfft_quad`` over the device time of the kernels."""

from gpbench.yardstick.roofline import PERM_FFT_CALLS, PERM_FFT_KERNELS, share_pct

CALLS = PERM_FFT_CALLS


def read(ctx):
    return share_pct(ctx, {c[2] for c in CALLS}, PERM_FFT_KERNELS)
