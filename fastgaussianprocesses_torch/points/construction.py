"""Fast component-by-component (CBC) construction of rank-1 lattice
generating vectors for n = 2^m points (counterpart of
``fastgaussianprocesses_tpu/points/construction.py``, numpy on the host; its
vectors equal the JAX package's exactly).

The packaged tables ``points/data/lattice_cbc_m*.npy`` were built this way;
the module constructs vectors for any (m, d, weights).

Criterion: squared worst-case error in the weighted Korobov space with
product weights gamma_j and the order-1 shift-invariant kernel term
``omega(x) = 2 pi^2 B_2(x)``:

    e^2(z_1..z_s) = -1 + (1/n) sum_k prod_j (1 + gamma_j omega({k z_j / n}))

Fast evaluation over all odd candidates z uses the Nuyens–Cools group
structure: split k by 2-adic valuation into levels k = 2^c u; on each level
the map (u, w) -> u*w runs over the unit group U_{2^(m-c)} = {+-3^i}, so the
candidate sweep is a group convolution over Z_2 x Z_{2^(m-c-2)} computed
with one FFT per level.  Total cost O(d n log n).
"""

import functools

import numpy as np


def _omega(x):
    """2 pi^2 B_2(x) — order-1 SI kernel series term."""
    return 2.0 * np.pi**2 * (x * x - x + 1.0 / 6.0)


@functools.lru_cache(maxsize=32)
def _unit_group(nc: int):
    """Enumerate U_{nc} as sign x power-of-3: element [s, i] = (-1)^s 3^i mod nc.

    Returns (elements array shape (2, M), index lookup dict value->(s, i)).
    Requires nc >= 8.
    """
    M = nc // 4
    powers = np.empty(M, dtype=np.int64)
    v = 1
    for i in range(M):
        powers[i] = v
        v = (v * 3) % nc
    elems = np.stack([powers, (-powers) % nc])  # (2, M)
    lookup = np.full(nc, -1, dtype=np.int64)
    sign = np.full(nc, -1, dtype=np.int64)
    for s in range(2):
        for i in range(M):
            lookup[elems[s, i]] = i
            sign[elems[s, i]] = s
    return elems, lookup, sign


def _group_fft(a):
    """FFT over Z_2 x Z_M: 2-point transform on axis 0, FFT on axis 1."""
    b = np.stack([a[0] + a[1], a[0] - a[1]])
    return np.fft.fft(b, axis=1)


def _group_ifft(A):
    B = np.fft.ifft(A, axis=1)
    return np.stack([(B[0] + B[1]) / 2.0, (B[0] - B[1]) / 2.0])


def _level_convolve(q_vals, om_vals):
    """Group correlation C[w] = sum_u q(u) om(u*w) over U_{nc}.

    In (sign, power) exponent coordinates this is C(b) = sum_a q(a) om(a+b),
    i.e. a correlation: conj on the q spectrum along the cyclic axis.
    """
    return _group_ifft(np.conj(_group_fft(q_vals)) * _group_fft(om_vals)).real


def cbc_lattice(m: int, d: int, gamma=None, verbose: bool = False) -> np.ndarray:
    """Construct a generating vector for n = 2^m points in d dimensions.

    Args:
        gamma: product weights per dimension (default j^-2 decay).

    Returns:
        uint64 vector of length d (component 0 is always 1).
    """
    n = 1 << m
    if m < 3:
        raise ValueError("need n >= 8")
    if gamma is None:
        gamma = 1.0 / np.arange(1, d + 1) ** 2
    gamma = np.asarray(gamma, dtype=np.float64)
    if gamma.shape != (d,):
        raise ValueError(f"gamma needs {d} weights")

    # p[k] = prod over chosen dims of (1 + gamma_j omega({k z_j / n}))
    p = np.ones(n, dtype=np.float64)
    z = np.ones(d, dtype=np.uint64)

    # level bookkeeping: ks of each 2-adic valuation
    levels = []
    for c in range(m):
        nc = n >> c
        u = np.arange(1, nc, 2, dtype=np.int64)  # odd residues mod nc
        k = (u << c)
        levels.append((c, nc, u, k))

    omega_cache = {}
    for c, nc, u, k in levels:
        if nc >= 8:
            elems, lookup, sign = _unit_group(nc)
            om = _omega((elems.astype(np.float64)) / nc)  # omega({w/nc}) in group layout
            omega_cache[nc] = (elems, lookup, sign, om)

    for j in range(d):
        if j == 0:
            zj = 1
        else:
            scores = np.zeros(n // 2)  # indexed by odd z -> (z-1)//2
            for c, nc, u, k in levels:
                q = p[k]
                if nc >= 8:
                    elems, lookup, sign, om = omega_cache[nc]
                    M = nc // 4
                    # arrange q over group layout: q_g[s, i] = q(u = elems[s, i])
                    q_g = np.zeros((2, M))
                    s_u, i_u = sign[u], lookup[u]
                    q_g[s_u, i_u] = q
                    # C[w] = sum_u q(u) omega({u w / nc}): substitute u = g, w = h:
                    # omega argument index u*w -> group convolution
                    conv = _level_convolve(q_g, om)  # (2, M) indexed by group elem w
                    # scatter to candidate z: score contribution at z with
                    # z mod nc == elems[s, i]
                    zs = np.arange(1, n, 2, dtype=np.int64)
                    zmod = zs % nc
                    scores += conv[sign[zmod], lookup[zmod]]
                else:
                    # tiny levels: direct sum
                    zs = np.arange(1, n, 2, dtype=np.int64)
                    x = ((np.outer(u, zs) % nc).astype(np.float64)) / nc
                    scores += _omega(x).T @ q if len(u) else 0.0
            # k = 0 term contributes p[0]*omega(0) to every candidate equally
            scores += p[0] * _omega(0.0)
            best = int(np.argmin(scores))
            zj = 2 * best + 1
        z[j] = zj
        xk = ((np.arange(n, dtype=np.int64) * zj) % n).astype(np.float64) / n
        p *= 1.0 + gamma[j] * _omega(xk)
        if verbose:
            e2 = p.mean() - 1.0
            print(f"  dim {j + 1}: z = {zj}, e2 = {e2:.6e}", flush=True)
    return z


def squared_worst_case_error(z, m, gamma=None):
    """e^2 of the lattice defined by z (direct O(n d) evaluation)."""
    z = np.asarray(z, dtype=np.int64)
    d = len(z)
    n = 1 << m
    if gamma is None:
        gamma = 1.0 / np.arange(1, d + 1) ** 2
    p = np.ones(n)
    for j in range(d):
        xk = ((np.arange(n, dtype=np.int64) * int(z[j])) % n).astype(np.float64) / n
        p *= 1.0 + gamma[j] * _omega(xk)
    return p.mean() - 1.0
