"""Dense GP kernels: Gaussian and Matern 1/2, 3/2, 5/2, with derivative
kernels by forward-mode autodiff (counterpart of
``fastgaussianprocesses_tpu/kernels/dense.py``).

Each derivative multi-index pair is a composition of ``torch.func.jacfwd``
over the two arguments of the scalar kernel, mapped by ``torch.func.vmap``
over the flattened point pairs with the parameter batch inside, as the JAX
package composes ``jax.jacfwd`` under ``jax.vmap``.
"""

import math

import numpy as np
import torch

KERNEL_CLASSES = ("gaussian", "matern12", "matern32", "matern52")


def _base_formula(kind, sqdist_half):
    """Kernel value from sum_j (x_j - z_j)^2 / (2 l_j)."""
    if kind == "gaussian":
        return torch.exp(-sqdist_half)
    dist = torch.sqrt(sqdist_half)
    if kind == "matern12":
        return torch.exp(-dist)
    if kind == "matern32":
        return (1 + math.sqrt(3) * dist) * torch.exp(-math.sqrt(3) * dist)
    if kind == "matern52":
        return (1 + math.sqrt(5) * dist + 5 * dist**2 / 3) * torch.exp(-math.sqrt(5) * dist)
    raise ValueError(kind)


def _partial(g, argnum: int, j: int):
    """``d g / d(arg argnum)_j`` of a scalar-in-points function ``g(x, z)``."""
    return lambda x, z: torch.func.jacfwd(g, argnums=argnum)(x, z)[..., j]


def dense_kernel(kind, x0, x1, beta0, beta1, c0, c1, scale, lengthscales):
    """Evaluate the (derivative-)kernel with broadcasting.

    Args:
        x0, x1: broadcastable (..., d) point tensors.
        beta0, beta1: (p0, d), (p1, d) static derivative multi-indices.
        c0, c1: (p0,), (p1,) coefficients.
        scale: (*pb, 1); lengthscales: (*pb, d) or (*pb, 1).

    Returns:
        (*pb_broadcast, ...) kernel values.
    """
    beta0 = np.asarray(beta0, dtype=np.int64)
    beta1 = np.asarray(beta1, dtype=np.int64)
    d = x0.shape[-1]
    if (beta0 == 0).all() and (beta1 == 0).all():
        nd = max(x0.ndim, x1.ndim)
        ls = lengthscales.reshape(lengthscales.shape[:-1] + (1,) * (nd - 1)
                                  + lengthscales.shape[-1:])
        sc = scale.reshape(scale.shape[:-1] + (1,) * (nd - 1))
        sqd = ((x0 - x1) ** 2 / (2 * ls)).sum(-1)
        val = sc * _base_formula(kind, sqd)
        coeff = float(np.sum(np.outer(np.asarray(c0), np.asarray(c1))))
        return coeff * val

    # derivative path: scalar-in-points function with the parameter batch inside
    def base(x, z):
        sqd = ((x - z) ** 2 / (2 * lengthscales)).sum(-1)
        return scale[..., 0] * _base_formula(kind, sqd)

    def deriv_fn(b0row, b1row):
        f = base
        for j in range(d):
            for _ in range(int(b0row[j])):
                f = _partial(f, 0, j)
        for j in range(d):
            for _ in range(int(b1row[j])):
                f = _partial(f, 1, j)
        return f

    shape = tuple(np.broadcast_shapes(tuple(x0.shape[:-1]), tuple(x1.shape[:-1])))
    x0b = x0.expand(shape + (d,)).reshape(-1, d)
    x1b = x1.expand(shape + (d,)).reshape(-1, d)
    total = None
    for i0 in range(len(beta0)):
        for i1 in range(len(beta1)):
            vals = torch.func.vmap(deriv_fn(beta0[i0], beta1[i1]))(x0b, x1b)  # (P, *pb)
            term = float(c0[i0]) * float(c1[i1]) * vals
            total = term if total is None else total + term
    pb_ndim = total.ndim - 1
    total = torch.movedim(total, 0, -1)  # (*pb, P)
    return total.reshape(total.shape[:-1] + shape) if pb_ndim else total.reshape(shape)
