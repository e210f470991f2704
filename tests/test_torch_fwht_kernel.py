"""Port parity for kernel K4's algorithm (ops/fwht ``fwht_plan`` and
``fwht_emulate``: the tiles, register steps, padded exchanges and ticket
order of ``csrc/fwht.cu`` in plain PyTorch) against a float32 numpy
butterfly network, float64, the JAX package's contraction and its Pallas
kernel in interpret mode, and the JAX package's ``ft_stable_fwht``.  The
CUDA kernel itself is held against the same network on the card
(tests/test_torch_fwht.py, ``-m cuda``)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fastgaussianprocesses_torch.ops import fwht as tf  # noqa: E402
from fastgaussianprocesses_torch.ops import transforms as ttr  # noqa: E402
from fastgaussianprocesses_tpu.ops import transforms as jtr  # noqa: E402
from fastgaussianprocesses_tpu.ops.pallas_fwht import fwht_pallas  # noqa: E402

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def np_fwht(x):
    """Orthonormal FWHT of the rows, in x's dtype: radix-2 butterflies, the
    lowest index bit first, 1/sqrt(n) at the end (``chip_smoke.np_fwht``)."""
    R, n = x.shape
    y, h = x.copy(), 1
    while h < n:
        y = y.reshape(R, -1, 2, h)
        y = np.concatenate([y[:, :, :1] + y[:, :, 1:], y[:, :, :1] - y[:, :, 1:]], 2)
        y = y.reshape(R, n)
        h *= 2
    return y * x.dtype.type(1.0 / math.sqrt(n))


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _rows(m, R, dtype=np.float32, seed=None):
    rng = np.random.default_rng(m if seed is None else seed)
    return (rng.standard_normal((R, 1 << m)) + 1.5).astype(dtype)


def _lay_off(q, a, b):
    return ((q & 3) << a) | ((q >> 2) << b)


@pytest.mark.parametrize("m", range(0, 23))
def test_plan_touches_each_index_once_per_pass(m):
    """On index arrays, for R = 1, 3 and 119: every pass's tickets name each
    of its tiles once; the tiles' loads and stores (in the layouts the kernel
    loads and stores in) touch each (row, index) exactly once per pass; a
    later-pass tile comes after every earlier-pass tile of its row; every
    register layout is a permutation of the tile; and the kernel's shortcut
    for shared-memory slots (base slot + a constant per register) holds in
    every layout.  With several passes a tile lies in one row and its offsets
    are the row's plus a shift, so at R = 119 (and R = 3 above 2^20) the
    element check covers the last row, R = 1 the first."""
    n = 1 << m
    for R in (1, 3, 119):
        plan = tf.fwht_plan(n, R)
        P = len(plan.passes)
        assert sum(k for _, k in plan.passes) == m
        p_of, f_of = tf.ticket_tiles(plan, np.arange(plan.tickets))
        for p in range(P):
            assert np.array_equal(np.sort(f_of[p_of == p]), np.arange(plan.tiles))
        if P > 1:
            row = f_of // plan.tiles_per_row
            last = np.full((P, R), -1)
            np.maximum.at(last, (p_of, row), np.arange(plan.tickets))
            later = p_of > 0
            assert (last[p_of[later] - 1, row[later]] < np.flatnonzero(later)).all()
        for p in range(P):
            steps = plan.steps[p]
            for a, b in {st[:2] for st in steps} | {tf.VEC}:
                idx = tf.layout_index(plan.log_tile, a, b)
                assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(1 << plan.log_tile))
                off_q = _lay_off(np.arange(16), a, b)
                assert np.array_equal(tf._pad32(idx), tf._pad32(idx[:, :1]) + off_q
                                      + (off_q >> 5))
            tiles = np.arange(plan.tiles)
            part = P > 1 and R > 1 and (R > 3 or m > 20)  # the last row (R = 1: the first)
            if part:
                tiles = tiles[-plan.tiles_per_row:]
            for a, b in ({tf.VEC} if p == 0 else {steps[0][:2], steps[-1][:2]}):
                off = tf.tile_offsets(plan, p, tiles, a, b).reshape(-1)
                off = off[off >= 0]
                if P > 1:
                    row = np.repeat(tiles // plan.tiles_per_row, 1 << plan.log_tile)
                    assert (off >> m == row).all()
                    rank = row - (R - 1) if part else row
                    off = (rank << m) + (off & (n - 1))
                assert off.size == min(tiles.size << plan.log_tile, R << m)
                assert (np.bincount(off, minlength=off.size) == 1).all()


@pytest.mark.parametrize("m", range(0, 23))
def test_emulate_bitwise_equals_numpy_butterflies(m):
    """Float32: the emulation equals the numpy butterfly network bit for bit
    at every n = 2^0..2^22 (R = 1 and 3 up to 2^16, R = 1 above), and with
    groups of one row (every group boundary, a ragged last group) at
    2^13..2^16."""
    for R in ((1, 3) if m <= 16 else (1,)):
        x = _rows(m, R)
        assert np.array_equal(tf.fwht_emulate(torch.from_numpy(x)).numpy(), np_fwht(x))
    if 13 <= m <= 16:
        x = _rows(m, 5)
        got = tf.fwht_emulate(torch.from_numpy(x), group_bytes=1).numpy()
        assert np.array_equal(got, np_fwht(x))


@pytest.mark.parametrize("m", [0, 3, 12, 13, 14, 15, 17])
def test_emulate_float64_matches_network(m):
    """Float64: within 1e-13 of the max against the float64 network."""
    x = _rows(m, 3, np.float64)
    assert _rel(tf.fwht_emulate(torch.from_numpy(x)).numpy(), np_fwht(x)) < 1e-13


def test_emulate_matches_jax_contraction_and_pallas():
    """n = 2^14, R = 3, float32: within 8 ulps of the max of the JAX
    package's contraction and of its Pallas kernel in interpret mode (three
    evaluations that add in other orders)."""
    x = _rows(14, 3)
    got = tf.fwht_emulate(torch.from_numpy(x)).numpy()
    for want in (np.asarray(jtr.fwht(jnp.asarray(x))),
                 np.asarray(fwht_pallas(jnp.asarray(x), interpret=True))):
        assert _rel(got, want) < 8 * EPS32


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 8 * EPS32)])
@pytest.mark.parametrize("m", [12, 16])
def test_centre_on_load_matches_jax_ft_stable_fwht(m, dtype, tol):
    """The card's form of ``ft_stable_fwht`` (the emulation subtracting the
    row means as it loads) against the JAX package's: float64 within 1e-12,
    float32 within 8 ulps of the max; in float32 it also equals centring
    first (``_stabilize``) bit for bit, as the kernel must."""
    x = _rows(m, 3, dtype) + 4.0
    got = ttr._centre_on_load(tf.fwht_emulate, torch.from_numpy(x)).numpy()
    want = np.asarray(jtr.ft_stable_fwht(jnp.asarray(x)))
    assert got.dtype == want.dtype and _rel(got, want) < tol
    if dtype == np.float32:
        same = ttr._stabilize(tf.fwht_emulate, torch.from_numpy(x)).numpy()
        assert np.array_equal(got, same)


def test_wrapper_mean_on_cpu_centres_first():
    """``fwht(x, mean)`` on the CPU is the plain version of ``x - mean``
    (batch dims kept) and counts no launch."""
    x = torch.from_numpy(_rows(10, 6).reshape(2, 3, -1))
    mu = x.mean(-1)
    tf.reset_launches()
    assert torch.equal(tf.fwht(x, mu), tf.fwht_plain(x - mu[..., None]))
    assert tf.launches == {"fwht": 0}
