r"""Closed-form weighted Walsh functions, the series term of the
digitally-shift-invariant kernel (counterpart of
``fastgaussianprocesses_tpu/ops/walsh_closed.py``).

The order-``alpha`` term ``omega_alpha(x) = sum_{k>=1} r_alpha(k) wal_k(x)``
collapses to an exact polynomial ``P_alpha(z, s1, s3)`` with rational
coefficients (the derivation is in the JAX module's docstring), where for a
t-bit integer x

* ``z = 2^{-a*}`` with ``a* = t - (index of the leading one-bit)`` (0 at x = 0);
* ``s_k = sum_{bits b set} 4^{-k (t - b)}`` for k = 1, 3 (orders <= 4 need no
  other power sums).

:func:`closed_poly` derives the coefficients once on the host, in exact
``fractions`` arithmetic.  At evaluation time s1 and s3 come from constant
bit-spread maps (Morton-style masked shifts) on <= 15-bit chunks, which stay
inside int32, and z from an exact leading-bit extraction.
"""

import functools
from fractions import Fraction as F

import torch

MAX_ALPHA = 4

# polynomial = dict[(iz, js1, ks3, mu)] -> Fraction, representing
# sum c * z^iz * s1^js1 * s3^ks3 * u^mu   (u = 2^{-b}, eliminated before use)
_ONE = {(0, 0, 0, 0): F(1)}


def _padd(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, F(0)) + v
        if out[k] == 0:
            del out[k]
    return out


def _pscale(a, c):
    return {} if c == 0 else {k: v * c for k, v in a.items()}


def _pmul(a, b):
    out = {}
    for ka, va in a.items():
        for kb, vb in b.items():
            k = tuple(x + y for x, y in zip(ka, kb))
            out[k] = out.get(k, F(0)) + va * vb
    return {k: v for k, v in out.items() if v != 0}


def _newton_e(power_sums, kmax):
    """e_0..e_kmax from polynomial-valued power sums p_1..p_kmax."""
    e = {0: _ONE}
    for k in range(1, kmax + 1):
        acc = {}
        for i in range(1, k + 1):
            acc = _padd(acc, _pscale(_pmul(e[k - i], power_sums[i]), F((-1) ** (i - 1))))
        e[k] = _pscale(acc, F(1, k))
    return e


def _e_tail(e_global, e_prefix, kmax):
    """e_i over W minus a prefix, from e_i(W) = sum_j e_j(prefix) e_{i-j}(tail)."""
    tail = {0: _ONE}
    for i in range(1, kmax + 1):
        acc = e_global[i]
        for j in range(1, i + 1):
            acc = _padd(acc, _pscale(_pmul(e_prefix[j], tail[i - j]), F(-1)))
        tail[i] = acc
    return tail


@functools.lru_cache(maxsize=None)
def closed_poly(alpha: int):
    """Exact coefficients of P_alpha: {(iz, js1, ks3): float}."""
    alpha = int(alpha)
    if not 1 <= alpha <= MAX_ALPHA:
        raise ValueError(f"alpha must be in [1, {MAX_ALPHA}], got {alpha}")

    def C(k):  # sum_{a>=1} 2^{k(1-2a)}
        return F(2 ** k, 4 ** k - 1)

    # global power sums: p_k = C(k) - 2^{k+1} s_k (odd k), C(k) (even k)
    ps = {}
    for k in range(1, alpha):
        if k % 2 == 0:
            ps[k] = {(0, 0, 0, 0): C(k)}
        else:
            var = (0, 1, 0, 0) if k == 1 else (0, 0, 1, 0)
            ps[k] = {(0, 0, 0, 0): C(k), var: F(-(2 ** (k + 1)))}
    e_glob = _newton_e(ps, alpha - 1)

    total = {}
    for v in range(1, alpha):          # the v < alpha part
        total = _padd(total, e_glob[v])

    # b < a* part: prefix over positions 1..b is all zeros; prefix power sums
    # C(k) (1 - u^{2k}) with u = 2^{-b}
    ps_pre = {k: {(0, 0, 0, 0): C(k), (0, 0, 0, 2 * k): -C(k)} for k in range(1, alpha)}
    e_pre = _newton_e(ps_pre, alpha - 1)
    e_gt_b = _e_tail(e_glob, e_pre, alpha - 1)
    # term_b = 2^{b-1} w_b e_{alpha-1}(>b) with w_b = 2 u^2, 2^{b-1} = 1/(2u)
    bpart_u = _pmul({(0, 0, 0, 1): F(1)}, e_gt_b[alpha - 1])
    # sum over b = 1..a*-1:  u^m -> (1 - 2^m z^m) / (2^m - 1)
    bpart = {}
    for (iz, j, k, m), c in bpart_u.items():
        denom = 2 ** m - 1
        bpart = _padd(bpart, {(iz, j, k, 0): c * F(1, denom),
                              (iz + m, j, k, 0): -c * F(2 ** m, denom)})
    total = _padd(total, bpart)

    # b = a* part: prefix through a* is zeros then the a* element with
    # w = -2 z^2; prefix power sums C(k)(1 - (4 z^2)^k) + (-2 z^2)^k
    ps_star = {k: {(0, 0, 0, 0): C(k), (2 * k, 0, 0, 0): F((-2) ** k) - C(k) * (4 ** k)}
               for k in range(1, alpha)}
    e_star = _newton_e(ps_star, alpha - 1)
    e_gt_star = _e_tail(e_glob, e_star, alpha - 1)
    # 2^{a*-1} w_{a*} = (1/(2z)) (-2 z^2) = -z
    total = _padd(total, _pscale(_pmul({(1, 0, 0, 0): F(1)}, e_gt_star[alpha - 1]), F(-1)))
    return {(iz, j, k): float(c) for (iz, j, k, _), c in total.items()}


_SPREAD2_MASKS = ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555))


def _spread2(v):
    """Deposit the low 15 bits of int32 ``v`` at even positions (bit b -> 2b).
    The largest intermediate is below 2^31, so bit 31 is never set."""
    for sh, mask in _SPREAD2_MASKS:
        v = (v | (v << sh)) & mask
    return v


def _spread6(v):
    """Deposit the low 5 bits of int32 ``v`` at positions 0, 6, 12, 18, 24."""
    return ((v & 1) | ((v & 2) << 5) | ((v & 4) << 10) | ((v & 8) << 15) | ((v & 16) << 20))


def _chunks(v, t, chunk_bits, spread):
    """Spread features of the <= chunk_bits-bit chunks of ``v``, as int32,
    one chunk at a time."""
    mask = (1 << chunk_bits) - 1
    for c in range(-(-t // chunk_bits)):
        yield spread(((v >> (chunk_bits * c)) & mask).to(torch.int32))


def _weighted_sum(feats, t, chunk_bits, stride_bits, dtype):
    """s_k = sum over chunks of feature * 2^{k' (chunk_base - t)}, k' = 2 * stride.
    ``feats`` is consumed lazily, so one chunk's feature is live at a time."""
    kk = 2 * stride_bits
    out = None
    for c, f in enumerate(feats):
        term = f.to(dtype).mul_(float(2.0 ** (kk * (chunk_bits * c - t))))
        out = term if out is None else out.add_(term)
    return out


def _z_from_bits(delta, t, dtype):
    """z = 2^{lead - t} with ``lead`` the index of the leading one-bit of
    ``delta`` (z = 0 at delta = 0), exactly.

    ``delta & ~(delta >> 1)`` keeps the leading bit and has no two adjacent
    bits set below it, so its conversion to float cannot round up to the
    next power of two (a plain cast turns 2^30 - 1 into 2^30 in float32).
    Masking the float's exponent field then leaves exactly 2^lead."""
    f = (delta >> 1).bitwise_not_().bitwise_and_(delta).to(dtype)
    ibits = torch.int32 if dtype == torch.float32 else torch.int64
    emask = 0x7F800000 if dtype == torch.float32 else 0x7FF0000000000000
    f.view(ibits).bitwise_and_(emask)
    return f.mul_(float(2.0 ** -t))


def _eval_poly(coeffs, z, s1, s3, dtype):
    """sum_{j,k} s1^j s3^k * (z-polynomial), inner polynomials by Horner, in
    the JAX package's order of operations."""
    by_jk = {}
    for (iz, j, k), c in coeffs.items():
        by_jk.setdefault((j, k), {})[iz] = c
    out = None
    s1p = {1: s1}
    for (j, k), zpoly in sorted(by_jk.items()):
        deg = max(zpoly)
        acc = torch.full(z.shape, zpoly.get(deg, 0.0), dtype=dtype, device=z.device)
        for i in range(deg - 1, -1, -1):
            acc.mul_(z).add_(zpoly.get(i, 0.0))
        if j:
            if j not in s1p:
                s1p[j] = s1p[j - 1] * s1
            acc.mul_(s1p[j])
        if k:
            acc.mul_(s3)
        out = acc if out is None else out.add_(acc)
    return out


def _check(t, alpha):
    if not 1 <= alpha <= MAX_ALPHA:
        raise ValueError(f"alpha must be in [1, {MAX_ALPHA}], got {alpha}")
    if not 1 <= t <= 53:
        raise ValueError(f"t must be in [1, 53], got {t}")


def omega_walsh_closed(xb, t: int, alpha: int, dtype=torch.float64):
    """``omega_alpha`` at t-bit fixed-point integers ``xb`` (int32 for
    t <= 30, else int64), in O(alpha + log t) elementwise ops."""
    alpha, t = int(alpha), int(t)
    _check(t, alpha)
    coeffs = closed_poly(alpha)
    z = _z_from_bits(xb, t, dtype)
    s1 = _weighted_sum(_chunks(xb, t, 15, _spread2), t, 15, 1, dtype)
    need_s3 = any(k > 0 for (_, _, k) in coeffs)
    s3 = _weighted_sum(_chunks(xb, t, 5, _spread6), t, 5, 3, dtype) if need_s3 else None
    return _eval_poly(coeffs, z, s1, s3, dtype)


def omega_walsh_closed_pair(xb, zb, t: int, alpha: int, dtype=torch.float64):
    """``omega_alpha(xb XOR zb)`` for broadcastable sides ``xb`` and ``zb``.

    The bit spreads are bit permutations of each chunk, so they commute with
    XOR: ``spread(chunk(x ^ z)) == spread(chunk(x)) ^ spread(chunk(z))``.  Each
    side is spread once, on its own shape; the work on the broadcast pair
    shape is one XOR, one convert and one multiply-add per chunk, the
    leading-bit extraction and the polynomial.
    """
    alpha, t = int(alpha), int(t)
    _check(t, alpha)
    coeffs = closed_poly(alpha)
    z = _z_from_bits(xb ^ zb, t, dtype)

    def pair_sum(chunk_bits, spread, stride_bits):
        fx = list(_chunks(xb, t, chunk_bits, spread))      # side-sized
        fz = list(_chunks(zb, t, chunk_bits, spread))
        return _weighted_sum((a ^ b for a, b in zip(fx, fz)), t, chunk_bits, stride_bits, dtype)

    s1 = pair_sum(15, _spread2, 1)
    need_s3 = any(k > 0 for (_, _, k) in coeffs)
    s3 = pair_sum(5, _spread6, 3) if need_s3 else None
    return _eval_poly(coeffs, z, s1, s3, dtype)
