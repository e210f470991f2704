"""Port parity: lattice points of fastgaussianprocesses_torch are bit-identical
to the JAX package's for the same seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402

torch.set_num_threads(2)


def test_lattice_seq_bit_identical():
    d, n = 8, 1 << 12
    got = ft.LatticeSeq(d, seed=7)(0, n)
    want = fj.LatticeSeq(d, seed=7)(0, n)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    # extensible: a later block equals the tail of the full sequence
    assert np.array_equal(ft.LatticeSeq(d, seed=7)(n // 2, n), want[n // 2:])


def test_model_points_spawned_seeds_bit_identical():
    """Per-task seeds are ``SeedSequence(seed_for_seq).spawn(num_tasks)``, as
    the JAX model constructor draws them."""
    d, n, T = 8, 1 << 12, 3
    gt = ft.FastGPLattice(d, num_tasks=T, seed_for_seq=7, device="cpu")
    gj = fj.FastGPLattice(d, num_tasks=T, seed_for_seq=7)
    xt = gt.get_x_next([n] * T)
    xj = gj.get_x_next([n] * T)
    for a, b in zip(xt, xj):
        assert a.dtype == torch.float64
        assert np.array_equal(a.numpy(), np.asarray(b))
    # single task
    x1 = ft.FastGPLattice(d, seed_for_seq=7, device="cpu").get_x_next(n).numpy()
    assert np.array_equal(x1, np.asarray(fj.FastGPLattice(d, seed_for_seq=7).get_x_next(n)))
