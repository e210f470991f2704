"""Bernoulli polynomials B_1..B_8 evaluated by Horner's rule (counterpart of
``fastgaussianprocesses_tpu/ops/bernoulli.py``).

These are the per-dimension series terms of the shift-invariant lattice
kernels.  Coefficients are the exact rational Bernoulli-polynomial
coefficients, highest degree first.
"""

import math

import torch

# B_n(x) coefficients, highest power first.
_BERNOULLI_COEFFS = {
    1: [1.0, -0.5],
    2: [1.0, -1.0, 1.0 / 6.0],
    3: [1.0, -1.5, 0.5, 0.0],
    4: [1.0, -2.0, 1.0, 0.0, -1.0 / 30.0],
    5: [1.0, -2.5, 5.0 / 3.0, 0.0, -1.0 / 6.0, 0.0],
    6: [1.0, -3.0, 2.5, 0.0, -0.5, 0.0, 1.0 / 42.0],
    7: [1.0, -3.5, 3.5, 0.0, -7.0 / 6.0, 0.0, 1.0 / 6.0, 0.0],
    8: [1.0, -4.0, 14.0 / 3.0, 0.0, -7.0 / 3.0, 0.0, 2.0 / 3.0, 0.0, -1.0 / 30.0],
}

MAX_ORDER = max(_BERNOULLI_COEFFS)


def bernoulli_poly(order: int, x: torch.Tensor) -> torch.Tensor:
    """Evaluate ``B_order`` elementwise (``x`` expected in [0, 1)).

    Horner's rule runs in place on one fresh buffer, so a query-scale
    ``(chunk, n)`` input costs one extra buffer, not one per coefficient.
    """
    coeffs = _BERNOULLI_COEFFS[int(order)]
    y = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        y.mul_(x).add_(c)
    return y


def si_coeff(alpha_j: int, b: int, k: int) -> float:
    """The factor ``(-1)^(alpha_j + k + 1) (2 pi)^(2 alpha_j) / m!`` of
    ``B_m``, ``m = 2 alpha_j - b - k``, in the lattice's shift-invariant
    series for one dimension of smoothness ``alpha_j`` and derivative
    orders ``b``, ``k``."""
    order = 2 * alpha_j - b - k
    if order < 2:
        raise ValueError(f"kernel order must be >= 2, got {order}")
    return float((-1.0) ** (alpha_j + k + 1)) * math.exp(
        2 * alpha_j * math.log(2 * math.pi) - math.lgamma(order + 1))
