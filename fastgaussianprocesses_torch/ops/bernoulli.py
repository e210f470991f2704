"""Bernoulli polynomials B_1..B_8 evaluated by Horner's rule (counterpart of
``fastgaussianprocesses_tpu/ops/bernoulli.py``).

These are the per-dimension series terms of the shift-invariant lattice
kernels.  Coefficients are the exact rational Bernoulli-polynomial
coefficients, highest degree first.
"""

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
