r"""Weighted Walsh functions for digitally-shift-invariant kernels
(counterpart of ``fastgaussianprocesses_tpu/ops/walsh.py``: the series by a
transfer recursion, its brute-force numpy oracle and the order-1 closed
form).  The kernels evaluate the closed form of ``ops/walsh_closed``; this
module is what it is checked against.

The order-``alpha`` DSI kernel series term is

    omega_alpha(x) = sum_{k>=1} r_alpha(k) * wal_k(x),

where ``wal_k`` are the Walsh functions and the weights have the Dick product
form over the binary-digit positions ``a_1 > a_2 > ... > a_v`` of ``k``
(positions 1-indexed from the most significant fractional bit):

    r_alpha(k) = prod_{i=1}^{min(v, alpha)} 2^(1 - 2*a_i).

For alpha = 1 this reproduces the classical closed form
``omega_1(x) = 1 - 3 * 2^{floor(log2 x)}`` used by the reference for
first-order terms (fast_gp_digital_net_b2.py:298); higher orders match the
higher-order weighted Walsh sums of qmcpy's ``weighted_walsh_funcs``
(called at fast_gp_digital_net_b2.py:300).

Rather than hard-coding per-order closed forms, ``omega_walsh`` evaluates the
series *exactly* with a transfer recursion over the t bit positions of the
input.  State: elementary weighted sums ``g_j`` over subsets of size j < alpha
of already-processed (higher) positions, and an accumulator ``h`` for subsets
of size >= alpha (whose weight only involves their top alpha positions).  The
infinite tail over positions > t (where all input bits are zero) has a closed
form used as the initial state.  Cost: O(t * alpha) elementwise tensor ops,
no gathers, no data-dependent control flow.
"""

import functools

import numpy as np
import torch

MAX_ALPHA = 4


@functools.lru_cache(maxsize=None)
def _tail_constants(alpha: int, t: int):
    """Initial state (g_j, h) accounting for all bit positions > t."""
    # c_j = elementary symmetric sum of {4^-i : i >= 1} of order j
    c = np.ones(alpha, dtype=np.float64)
    for j in range(1, alpha):
        c[j] = 4.0 ** (-j * (j + 1) / 2.0) / np.prod(1.0 - 4.0 ** (-np.arange(1, j + 1)))
    g0 = [2.0**j * 4.0 ** (-j * t) * c[j] for j in range(alpha)]
    h0 = (
        2.0 ** (alpha - 1)
        * c[alpha - 1]
        * 2.0 ** (-t)
        * 2.0 ** (-(2 * alpha - 1) * (t + 1))
        / (1.0 - 2.0 ** (-(2 * alpha - 1)))
    )
    return g0, h0


def omega_walsh(xb, t: int, alpha: int, dtype=torch.float64):
    """Evaluate ``omega_alpha`` at t-bit fixed-point inputs ``xb`` (integers).

    Args:
        xb: integer tensor of binary fractions scaled by 2^t (values in [0, 2^t)).
        t: static number of bits (<= 53 for float64 accuracy).
        alpha: static smoothness order in [1, MAX_ALPHA].

    Returns:
        Tensor of ``dtype`` with ``omega_alpha(xb * 2^-t)`` elementwise.
    """
    alpha = int(alpha)
    t = int(t)
    if not (1 <= alpha <= MAX_ALPHA and 1 <= t <= 62):
        raise ValueError(f"need 1 <= alpha <= {MAX_ALPHA} and 1 <= t <= 62")
    xb = torch.as_tensor(xb)
    g0, h0 = _tail_constants(alpha, t)
    g = [torch.full(xb.shape, gj, dtype=dtype, device=xb.device) for gj in g0]
    h = torch.full(xb.shape, h0, dtype=dtype, device=xb.device)
    one = torch.ones((), dtype=dtype, device=xb.device)
    # process positions a = t down to 1 (least to most significant bit)
    for a in range(t, 0, -1):
        bit = ((xb >> (t - a)) & 1).to(dtype)
        eps = one - 2.0 * bit
        w_eps = (2.0 ** (1 - 2 * a)) * eps
        h = h * (one + eps) + w_eps * g[alpha - 1]
        for j in range(alpha - 1, 0, -1):
            g[j] = g[j] + w_eps * g[j - 1]
    out = h
    for j in range(1, alpha):
        out = out + g[j]
    return out


def omega_walsh_reference(x_bits: np.ndarray, t: int, alpha: int,
                          kmax: int = 1 << 18) -> np.ndarray:
    """Brute-force O(kmax) evaluation of the weighted Walsh series (test oracle).

    Sums ``r_alpha(k) * wal_k(x)`` for k = 1..kmax-1; truncation error is
    O(2^-log2(kmax)).  Numpy-only (vectorized over k); validates
    :func:`omega_walsh`.
    """
    x_bits = np.asarray(x_bits, dtype=np.uint64).ravel()
    k = np.arange(1, kmax, dtype=np.uint64)
    # weight: product of 2^(1-2a) over the top min(v, alpha) set-bit positions,
    # where integer bit b corresponds to position a = b + 1
    r = np.ones(k.shape, dtype=np.float64)
    kk = k.copy()
    for _ in range(alpha):
        nz = kk > 0
        msb = np.zeros(k.shape, dtype=np.uint64)
        msb[nz] = np.floor(np.log2(kk[nz].astype(np.float64))).astype(np.uint64)
        r[nz] *= 2.0 ** (-1.0 - 2.0 * msb[nz].astype(np.float64))
        kk[nz] &= ~(np.uint64(1) << msb[nz])
    # wal_k(x) over t-bit x: parity of k & reverse_t(x)
    xr = np.zeros_like(x_bits)
    for b in range(t):
        xr |= ((x_bits >> np.uint64(b)) & np.uint64(1)) << np.uint64(t - 1 - b)
    masked = k[None, :] & xr[:, None]
    parity = np.zeros(masked.shape, dtype=np.uint64)
    while masked.any():
        parity ^= masked & np.uint64(1)
        masked >>= np.uint64(1)
    signs = np.where(parity == 1, -1.0, 1.0)
    return signs @ r


def omega_order1_closed_form(xb, t: int, dtype=torch.float64):
    """Closed form ``1 - 3 * 2^{floor(log2 x)}`` for order 1 (test anchor).

    Matches the reference's special case (fast_gp_digital_net_b2.py:298):
    ``6 * (1/6 - 2^{floor(log2 xb) - t - 1})``; returns 1 at xb == 0.
    """
    xb = torch.as_tensor(xb)
    xf = xb.to(dtype)
    floor_log2 = torch.floor(torch.log2(torch.where(xb == 0, torch.ones_like(xf), xf))) - t
    val = 1.0 - 3.0 * torch.exp2(floor_log2)
    return torch.where(xb == 0, torch.ones((), dtype=dtype, device=xb.device), val.to(dtype))
