"""Extensible rank-1 lattice sequences in natural (van der Corput) order
(counterpart of ``fastgaussianprocesses_tpu/points/lattice.py``, numpy path).

Point i of the sequence is ``x_i = frac(vdc(i) * g + shift)`` where ``vdc``
is the base-2 radical inverse and ``g`` the integer generating vector.  The
first 2^m points form a rank-1 lattice whose shift-invariant Gram matrix is
circulant under the bit-reversal index map.

The generating vectors are the JAX package's CBC tables, copied into
``points/data``.  Points come from the host library ``points/native`` where
it builds, else from numpy; both are exact in float64 (vdc(i) has <= 32
mantissa bits and the components are < 2^20), so for the same seed the
points are bit-identical to the JAX package's.
"""

import os
import warnings

import numpy as np

from . import native

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
# the SMALLEST sufficient table is preferred (CBC vectors are tuned per n)
_CBC_FILES = [(20, os.path.join(_DATA_DIR, "lattice_cbc_m20.npy")),
              (24, os.path.join(_DATA_DIR, "lattice_cbc_m24.npy"))]

_DEF_M_MAX = 20


def _bitrev32(i: np.ndarray) -> np.ndarray:
    i = i.astype(np.uint32)
    i = ((i & 0x55555555) << 1) | ((i >> 1) & 0x55555555)
    i = ((i & 0x33333333) << 2) | ((i >> 2) & 0x33333333)
    i = ((i & 0x0F0F0F0F) << 4) | ((i >> 4) & 0x0F0F0F0F)
    i = ((i & 0x00FF00FF) << 8) | ((i >> 8) & 0x00FF00FF)
    return (i << 16) | (i >> 16)


def van_der_corput(indices: np.ndarray) -> np.ndarray:
    """Base-2 radical inverse of integer indices (exact float64)."""
    return _bitrev32(np.asarray(indices, dtype=np.uint32)).astype(np.float64) * 2.0**-32


def default_generating_vector(d: int, n_max: int = 1 << _DEF_M_MAX) -> np.ndarray:
    """Generating vector for up to ``n_max`` points in ``d`` dimensions: the
    packaged CBC table, else a deterministic pseudo-random odd vector."""
    for m_table, path in _CBC_FILES:
        if (1 << m_table) >= n_max and os.path.exists(path):
            table = np.load(path)
            if table.shape[0] >= d:
                return table[:d].astype(np.uint64)
    warnings.warn(
        f"no packaged CBC generating-vector table covers d={d}, n_max={n_max}; "
        "falling back to a pseudo-random odd vector.  The lattice stays valid "
        "but its convergence rate degrades.", UserWarning, stacklevel=2)
    rng = np.random.default_rng(42)
    g = rng.integers(1, n_max // 2, size=d, dtype=np.uint64) * 2 + 1
    g[0] = 1
    return g


class LatticeSeq:
    """Randomly-shifted rank-1 lattice sequence (natural order).

    Args:
        dimension: number of coordinates.
        seed: seed (int or ``np.random.SeedSequence``) of the random shift.
        randomize: "SHIFT" (uniform shift mod 1) or "FALSE".
        generating_vector: optional explicit odd integer vector of length
            ``dimension``; defaults to the packaged CBC table.
        m_max: points are valid for n <= 2^m_max.
    """

    order = "NATURAL"
    replications = 1

    def __init__(self, dimension, seed=None, randomize="SHIFT",
                 generating_vector=None, m_max=_DEF_M_MAX):
        self.d = int(dimension)
        if self.d < 1:
            raise ValueError("dimension must be >= 1")
        randomize = str(randomize).upper()
        if randomize not in ("SHIFT", "FALSE"):
            raise ValueError(f"randomize={randomize!r}")
        self.randomize = randomize
        self.m_max = int(m_max)
        if generating_vector is None:
            generating_vector = default_generating_vector(self.d, 1 << self.m_max)
        self.gen_vec = np.asarray(generating_vector, dtype=np.uint64)[: self.d]
        if self.gen_vec.shape != (self.d,) or not (self.gen_vec % 2 == 1).all():
            raise ValueError("generating vector needs d odd components")
        rng = np.random.default_rng(seed)
        self.shift = rng.uniform(size=self.d) if randomize == "SHIFT" else np.zeros(self.d)

    def __call__(self, n_min: int, n_max: int) -> np.ndarray:
        """Points with indices in [n_min, n_max), shape (n_max - n_min, d)."""
        if not 0 <= n_min <= n_max <= (1 << self.m_max):
            raise ValueError(f"indices [{n_min}, {n_max}) out of range")
        out = native.lattice_natural(self.gen_vec, int(n_min), int(n_max), self.shift)
        return self.numpy_points(n_min, n_max) if out is None else out

    def numpy_points(self, n_min: int, n_max: int) -> np.ndarray:
        """The numpy path of :meth:`__call__` (the host library's fallback)."""
        idx = np.arange(n_min, n_max, dtype=np.uint64)
        base = van_der_corput(idx)[:, None] * self.gen_vec[None, :].astype(np.float64)
        return (base + self.shift[None, :]) % 1.0
