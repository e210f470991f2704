"""FLOPs that a whole step's mathematics needs, counted from a
configuration's shapes whatever implements the step (the numerator of the
``mfu`` metrics).  The counts are the least arithmetic of the plain
algorithm; ``PERF.md`` gives their derivation.  Each configuration's file
``yardstick/flops/<configuration>.py`` names the counts of its steps, from
these or its own.

* Cross-kernel, a (query, point, dimension) triple: the difference and its
  reduction mod 1 (2), the degree-2a Bernoulli polynomial by Horner (4a),
  the lengthscale's product and the 1 added (2), the running product (1):
  ``5 + 4a`` FLOP; one more a pair for the scale.
* Series contraction of a first column, a point: ``3 d + 1`` (the factor's
  multiply-add and the product, a dimension; the scale); its backward twice
  that.
* Transforms: a real-input FFT 2.5 n log2 n (lattice), a Walsh-Hadamard
  transform n log2 n (digital net); a backward costs the same again.
* Residue blocks of M rows: inverse or factorization 2 M^3, a solve 2 M^2,
  the quadratic form 2 M; the backward twice the forward.
"""

import math

LATTICE = "FastGPLattice"


def _transform(model, n):
    return (2.5 if model == LATTICE else 1.0) * n * math.log2(n)


def lattice_request_flops(cfg, N):
    """One ``post_mean_var`` of N query points against every task's points of
    a one-task lattice: the cross-kernel, the mean's dot products (2 a pair),
    the variance's quadratic form (``quad_flops`` a row), and the solver's
    eigenvalues and coefficients (one contraction and two transforms)."""
    if cfg["model"] != LATTICE or len(cfg["n"]) != 1:
        raise ValueError("lattice_request_flops counts the one-task lattice")
    n, d, a = int(cfg["n"][0]), int(cfg["d"]), int(cfg["alpha"])
    per_pair = d * (5 + 4 * a) + 1 + 2 + 2.5 * math.log2(n) + 3
    solver = n * (3 * d + 1) + 2 * _transform(cfg["model"], n)
    return N * n * per_pair + solver


def fit_step_flops(cfg):
    """One MLL evaluation, its gradient and the Rprop update (whose O(leaves)
    FLOPs are left out): every task pair's contraction and transform
    forward and backward, the effective eigenvalues (4 a point of a diagonal
    pair), and the residue blocks' factorization and solve forward and
    backward."""
    ns = sorted((int(v) for v in cfg["n"]), reverse=True)
    d, model = int(cfg["d"]), cfg["model"]
    total = 0.0
    for a in range(len(ns)):
        for b in range(a, len(ns)):
            na = ns[a]
            total += 3 * na * (3 * d + 1) + 2 * _transform(model, na)
            if a == b:
                total += 4 * na
    n_min = ns[-1]
    M = sum(v // n_min for v in ns)
    total += 3 * n_min * (2 * M ** 3 + 2 * M ** 2 + 2 * M)
    return total


def hmc_gradient_flops(cfg, chains):
    """One gradient of the hyperposterior's log-density over all chains:
    the fit step's MLL and gradient, a chain (the prior's O(leaves) left out)."""
    return chains * fit_step_flops(cfg)
