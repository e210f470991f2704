"""Bit-manipulation helpers shared by point generators and fast transforms
(counterpart of ``fastgaussianprocesses_tpu/ops/bitops.py``; host numpy)."""

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def bit_reverse_permutation(m: int) -> np.ndarray:
    """Permutation ``rho`` with ``rho[i]`` = the m-bit reversal of ``i``.

    ``rho`` is an involution.  It relates the natural (van der Corput) order
    of extensible lattices to the cyclic order in which their Gram matrices
    are circulant.
    """
    if not 0 <= m <= 30:
        raise ValueError(f"m={m} out of range [0, 30]")
    n = 1 << m
    i = np.arange(n, dtype=np.uint32)
    r = np.zeros(n, dtype=np.uint32)
    for b in range(m):
        r |= ((i >> b) & 1) << (m - 1 - b)
    return r.astype(np.int64)


def log2_int(n: int) -> int:
    m = int(n).bit_length() - 1
    if n != (1 << m):
        raise ValueError(f"n={n} must be a power of two")
    return m
