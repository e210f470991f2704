"""Standard optimization test functions on [0,1]^d, with gradients
(counterpart of ``fastgaussianprocesses_tpu/utils/test_functions.py``): the
standard definitions (www.sfu.ca/~ssurjano) rescaled to the unit cube, on
tensors of shape (..., d)."""

import math

import numpy as np
import torch


def ackley(x, a=20.0, b=0.2, c=2 * math.pi, scaling=32.768):
    x = 2 * scaling * x - scaling
    t1 = a * torch.exp(-b * torch.sqrt(torch.mean(x**2, -1)))
    t2 = torch.exp(torch.mean(torch.cos(c * x), -1))
    return -t1 - t2 + a + math.e


def branin(x):
    if x.shape[-1] != 2:
        raise ValueError("branin is 2-dimensional")
    x1 = 15.0 * x[..., 0] - 5.0
    x2 = 15.0 * x[..., 1]
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * torch.cos(x1) + s


def six_hump_camel(x):
    if x.shape[-1] != 2:
        raise ValueError("six_hump_camel is 2-dimensional")
    x1 = 6.0 * x[..., 0] - 3.0
    x2 = 4.0 * x[..., 1] - 2.0
    return ((4 - 2.1 * x1**2 + x1**4 / 3) * x1**2 + x1 * x2
            + (-4 + 4 * x2**2) * x2**2)


def styblinski_tang(x):
    z = 10.0 * x - 5.0
    return 0.5 * torch.sum(z**4 - 16 * z**2 + 5 * z, -1)


_HARTMANN6_A = np.array([
    [10, 3, 17, 3.5, 1.7, 8],
    [0.05, 10, 17, 0.1, 8, 14],
    [3, 3.5, 1.7, 10, 17, 8],
    [17, 8, 0.05, 10, 0.1, 14],
])
_HARTMANN6_P = 1e-4 * np.array([
    [1312, 1696, 5569, 124, 8283, 5886],
    [2329, 4135, 8307, 3736, 1004, 9991],
    [2348, 1451, 3522, 2883, 3047, 6650],
    [4047, 8828, 8732, 5743, 1091, 381],
])
_HARTMANN6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])


def hartmann6(x):
    """The rescaled Hartmann-6, ``-(2.58 + sum_i alpha_i exp(...)) / 1.94``
    (the variant the reference benchmarks)."""
    if x.shape[-1] != 6:
        raise ValueError("hartmann6 is 6-dimensional")
    A, P, alpha = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                   for a in (_HARTMANN6_A, _HARTMANN6_P, _HARTMANN6_ALPHA))
    inner = ((x[..., None, :] - P) ** 2 * A).sum(-1)
    return -(2.58 + (alpha * torch.exp(-inner)).sum(-1)) / 1.94


SUITE = {
    "ackley_d1": (lambda x: ackley(x), 1),
    "branin": (branin, 2),
    "camel": (six_hump_camel, 2),
    "stytang": (styblinski_tang, 2),
    "hartmann": (hartmann6, 6),
}


def gradient(f):
    """Batched gradient of a test function: (N, d) points -> (N, d)."""
    return torch.func.vmap(torch.func.grad(lambda xi: torch.sum(f(xi[None, :]))))
