"""Port parity: Sobol' digital nets of fastgaussianprocesses_torch are
bit-identical to the JAX package's for the same seeds, for every
randomization and bit width."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("t", [30, 53])
@pytest.mark.parametrize("randomize", ["DS", "LMS", "LMS_DS", "FALSE"])
def test_digital_net_bit_identical(randomize, t):
    d, n = 8, 1 << 12
    got = ft.DigitalNetB2(d, seed=7, randomize=randomize, t=t)
    want = fj.DigitalNetB2(d, seed=7, randomize=randomize, t=t)
    assert np.array_equal(got.columns, want.columns) and np.array_equal(got.shift, want.shift)
    xb = got(0, n, return_binary=True)
    xb_j = want(0, n, return_binary=True)
    assert xb.dtype == xb_j.dtype and np.array_equal(xb, xb_j)
    assert np.array_equal(got(0, n), want(0, n))
    # extensible: a later block equals the tail of the full sequence
    assert np.array_equal(ft.DigitalNetB2(d, seed=7, randomize=randomize, t=t)(
        n // 2, n, return_binary=True), xb_j[n // 2:])


def test_model_points_spawned_seeds_bit_identical():
    """Per-task seeds are ``SeedSequence(seed_for_seq).spawn(num_tasks)``, as
    the JAX model constructor draws them; the model keeps the t-bit integers
    beside the floats."""
    d, n, T = 8, 1 << 12, 3
    gt = ft.FastGPDigitalNetB2(d, num_tasks=T, seed_for_seq=7, device="cpu")
    gj = fj.FastGPDigitalNetB2(d, num_tasks=T, seed_for_seq=7)
    for a, b in zip(gt.get_x_next([n] * T), gj.get_x_next([n] * T)):
        assert a.dtype == torch.float64
        assert np.array_equal(a.numpy(), np.asarray(b))
    for l in range(T):
        xb = gt.get_xb(l)
        assert xb.dtype == torch.int32
        assert np.array_equal(xb.numpy(), np.asarray(gj.get_xb(l)))
    x1 = ft.FastGPDigitalNetB2(d, seed_for_seq=7, device="cpu").get_x_next(n).numpy()
    assert np.array_equal(x1, np.asarray(fj.FastGPDigitalNetB2(d, seed_for_seq=7).get_x_next(n)))
