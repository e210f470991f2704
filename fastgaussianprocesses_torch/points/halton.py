"""Halton sequences (counterpart of ``fastgaussianprocesses_tpu/points/halton.py``).

A plain generalized Halton sequence with an optional random digit
permutation per dimension, numpy on the host.  The draws and the digit
expansion are the JAX package's, step for step, so for a seed the points are
bit-identical to its.
"""

import numpy as np

_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
    239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
    331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
    421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
    509, 521, 523, 541,
]


class Halton:
    """Scrambled Halton sequence.

    Args:
        dimension: number of coordinates (<= 100).
        seed: PRNG seed for per-dimension digit permutations; ``None`` or
            randomize="FALSE" yields the plain Halton sequence.
    """

    replications = 1

    def __init__(self, dimension, seed=None, randomize="PERM"):
        self.d = int(dimension)
        if not 1 <= self.d <= len(_PRIMES):
            raise ValueError(f"dimension must be in [1, {len(_PRIMES)}]")
        self.primes = _PRIMES[: self.d]
        randomize = str(randomize).upper()
        if randomize not in ("PERM", "FALSE"):
            raise ValueError(f"randomize={randomize!r}")
        self.randomize = randomize
        rng = np.random.default_rng(seed)
        self.perms = []
        for p in self.primes:
            if randomize == "PERM":
                perm = np.concatenate([[0], rng.permutation(np.arange(1, p))])
            else:
                perm = np.arange(p)
            self.perms.append(perm)

    def __call__(self, n_min: int, n_max: int) -> np.ndarray:
        idx = np.arange(n_min, n_max, dtype=np.int64)
        out = np.zeros((idx.size, self.d), dtype=np.float64)
        for j, p in enumerate(self.primes):
            i = idx.copy()
            f = 1.0
            x = np.zeros(idx.size, dtype=np.float64)
            perm = self.perms[j]
            while i.max(initial=0) > 0 or f == 1.0:
                f /= p
                x += perm[i % p] * f
                i //= p
                if f < 1e-17:
                    break
            out[:, j] = x
        return out
