"""The least work of the port's kernel ops, from their shapes alone, and the
roofline bound of that work on the card's published peaks (``peaks.py``).

Bytes: each input read once and each output written once, whatever the
kernel reads again.  FLOPs: the least the op's function needs, whatever the
kernel does (a real-input FFT 2.5 n log2 n a row, a complex one 5 n log2 n,
a Walsh-Hadamard transform n log2 n adds plus the n-point centring).
"""

import math

from .peaks import PEAK_BYTES_S, PEAK_FP32_S


def fft_flops(n, R):
    """``pfft`` on real rows and ``pifft_real`` (its transpose): a
    real-input FFT, 2.5 n log2 n FLOP a row."""
    return R * n * 2.5 * math.log2(n)


def cfft_flops(n, R):
    """``pifft`` with complex output: a complex FFT, 5 n log2 n a row."""
    return R * n * 5 * math.log2(n)


def quad_flops(n, R):
    """``sum_b w_b |FFT(x)_b|^2`` (``pfft_quad``): a real-input FFT and,
    per conjugate bin pair, |Z|^2 times the summed weights (~6 FLOP)."""
    return R * n * (2.5 * math.log2(n) + 3)


def fwht_flops(n, R):
    """The FWHT of R rows of length n, ``R n (log2 n + 1)``: the butterflies'
    adds and the centring subtraction."""
    return R * n * (math.log2(n) + 1)


def bound_s(nbytes, flops):
    """(seconds, "bytes" or "operations"): the least time of the work on the
    card, the larger of its bytes at the HBM rate and its FLOPs at the
    float32 rate."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _rows(shape):
    n = shape[-1]
    R = 1
    for s in shape[:-1]:
        R *= s
    return n, R


def op_work(op, shapes, complex_in=False):
    """(bytes, FLOPs) of one call of a public kernel op, from the shapes of
    its tensor arguments in call order: ``pfft`` (real rows in, complex64
    out; complex rows in: a complex FFT), ``pifft_real`` (complex64 in,
    float32 out), ``pifft`` (complex64 in and out), ``pfft_quad`` (float32
    rows and weights in, one float32 a row out), ``fwht`` (float32 rows in
    and out, plus the row means where given)."""
    n, R = _rows(shapes[0])
    if op == "pfft":
        if complex_in:
            return R * n * 16, cfft_flops(n, R)
        return R * n * (4 + 8), fft_flops(n, R)
    if op == "pifft_real":
        return R * n * (8 + 4), fft_flops(n, R)
    if op == "pifft":
        return R * n * 16, cfft_flops(n, R)
    if op == "pfft_quad":
        return R * n * 4 + n * 4 + R * 4, quad_flops(n, R)
    if op == "fwht":
        mean = R * 4 if len(shapes) > 1 else 0
        return R * n * 8 + mean, fwht_flops(n, R)
    raise ValueError(f"no yardstick for the op {op!r}")
