"""Base-2 digital nets (Sobol') in natural order with digital-shift / LMS
randomizations (counterpart of ``fastgaussianprocesses_tpu/points/digital_net.py``,
numpy doubling path).

Point i has t-bit coordinates ``xb_i = XOR_{set bits k of i} C[:, k]`` where
C are the generating-matrix columns (Joe-Kuo direction numbers, the JAX
package's table copied into ``points/data/sobol_directions_t30.npy``).
Natural order makes the digitally-shift-invariant Gram matrix a group matrix
over (Z_2)^m, diagonalized by the FWHT.

Randomizations:

* "DS"     -- XOR each coordinate with a random t-bit digital shift;
* "LMS"    -- left-multiply the generating matrices by a random
  lower-triangular unit-diagonal GF(2) matrix (per coordinate);
* "LMS_DS" -- both; "FALSE" -- none.

The random draws and the construction are the JAX package's, step for
step, so for the same seed the points are bit-identical to its.
"""

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
_DIRECTIONS_FILE = os.path.join(_DATA_DIR, "sobol_directions_t30.npy")

_T = 30  # bits of precision in the packaged direction numbers
_directions_cache = None


def _load_directions() -> np.ndarray:
    global _directions_cache
    if _directions_cache is None:
        _directions_cache = np.load(_DIRECTIONS_FILE)  # (d_max, m_max) uint32
    return _directions_cache


def _lms_scramble(columns: np.ndarray, rng, t: int) -> np.ndarray:
    """Apply a random lower-triangular unit-diagonal GF(2) left-scramble.

    ``columns``: (d, m_max) generating-matrix columns (MSB = bit t-1).  New
    column bit r is row r of S (t x t, rows below the diagonal random)
    dotted with the column's bit vector mod 2.
    """
    d, _ = columns.shape
    out = np.zeros_like(columns)
    for j in range(d):
        # random lower-triangular rows as bit masks; row r has bits r..t-1
        # (MSB-first bit index), diagonal forced to 1
        rows = rng.integers(0, 1 << t, size=t, dtype=np.uint64)
        for r in range(t):
            keep_mask = (1 << (t - r)) - 1  # bits at positions <= t-1-r
            row = (rows[r] & keep_mask) | (1 << (t - 1 - r))
            p = columns[j].astype(np.uint64) & row
            count = np.zeros_like(p)          # parity of the popcount
            while True:
                count ^= p & 1
                p >>= 1
                if not p.any():
                    break
            out[j] |= (count.astype(out.dtype) << np.asarray(t - 1 - r, dtype=out.dtype)).astype(
                out.dtype)
    return out


class DigitalNetB2:
    """Sobol' base-2 digital net sequence (natural order).

    Args:
        dimension: number of coordinates (<= the packaged table's).
        seed: seed (int or ``np.random.SeedSequence``) of the randomization.
        randomize: one of "DS", "LMS", "LMS_DS", "FALSE".
        t: output bit precision in [30, 53] (30 is the table's own).  For
            t > 30 the generating-matrix columns are shifted left; the low
            bits then carry only the randomization.  53 keeps the float
            form exact in float64.
    """

    order = "NATURAL"
    replications = 1

    def __init__(self, dimension, seed=None, randomize="DS", t=_T):
        self.d = int(dimension)
        table = _load_directions()
        if not 1 <= self.d <= table.shape[0]:
            raise ValueError(f"dimension must be in [1, {table.shape[0]}]")
        randomize = str(randomize).upper()
        if randomize not in ("DS", "LMS", "LMS_DS", "FALSE"):
            raise ValueError(f"randomize={randomize!r}")
        self.randomize = randomize
        if not _T <= t <= 53:
            raise ValueError("t must be in [30, 53]")
        self.t = int(t)
        self.m_max = table.shape[1]
        rng = np.random.default_rng(seed)
        if self.t == _T:
            cols = table[: self.d].copy()  # (d, m_max) uint32
        else:
            cols = table[: self.d].astype(np.uint64) << (self.t - _T)
        if "LMS" in randomize:
            cols = _lms_scramble(cols, rng, self.t)
        self.columns = cols
        idtype = np.uint32 if self.t == _T else np.uint64
        if "DS" in randomize:
            self.shift = rng.integers(0, 1 << self.t, size=self.d,
                                      dtype=np.uint64).astype(idtype)
        else:
            self.shift = np.zeros(self.d, dtype=idtype)
        # incrementally grown natural-order unshifted net (doubling construction)
        self._xb = np.zeros((1, self.d), dtype=idtype)

    def _grow(self, n: int):
        while self._xb.shape[0] < n:
            k = self._xb.shape[0].bit_length() - 1  # current size 2^k
            self._xb = np.concatenate([self._xb, self._xb ^ self.columns[:, k][None, :]], axis=0)

    def __call__(self, n_min: int, n_max: int, return_binary: bool = False):
        """Points with indices in [n_min, n_max); float in [0, 1) or t-bit ints."""
        if not 0 <= n_min <= n_max <= (1 << self.m_max):
            raise ValueError(f"indices [{n_min}, {n_max}) out of range")
        self._grow(n_max)
        xb = self._xb[n_min:n_max] ^ self.shift[None, :]
        if return_binary:
            return xb
        return xb.astype(np.float64) * 2.0**-self.t
