"""Port parity for the permuted-spectrum FFT (ops/perm_fft): the plain
versions of kernels K1-K3, which the wrappers run for CPU tensors, against
float64 numpy and the JAX package's Pallas kernels (interpret mode), with
the JAX package's own tolerances (tests/test_pallas_fft.py).  The CUDA
kernels themselves are held against the plain versions on the card; the
kernels' algorithm in plain PyTorch is tested in test_torch_pfft_kernels.py
(K1, K2) and test_torch_quad.py (K3)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fastgaussianprocesses_torch.ops import perm_fft as tp  # noqa: E402
from fastgaussianprocesses_torch.ops import transforms as ttr  # noqa: E402
from fastgaussianprocesses_tpu.ops import pallas_fft as pf  # noqa: E402

torch.set_num_threads(2)

SIZES = [1 << 14, 1 << 15]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", SIZES + [1 << 17, 1 << 22])
def test_plan_and_spectrum_perm_match_jax(n):
    assert tp._plan(n) == pf._plan(n)
    assert np.array_equal(tp.spectrum_perm(n), pf.spectrum_perm(n))


@pytest.mark.parametrize("n", SIZES)
def test_pfft_and_pifft_real_match_numpy_and_jax(n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, n)).astype(np.float32)
    perm = tp.spectrum_perm(n)
    want = np.fft.fft(x.astype(np.float64), axis=-1)[:, perm]
    got = tp.pfft(torch.from_numpy(x), n).numpy()
    ref = np.asarray(pf.pfft(jnp.asarray(x), n))
    assert got.dtype == np.complex64
    assert _rel(got, want) < 3e-6
    assert _rel(ref, want) < 3e-6
    # two float32 evaluations of one factorization: a few ulps of the max apart
    assert _rel(got, ref) < 3e-6
    back = tp.pifft_real(torch.from_numpy(got), n).numpy()
    assert np.abs(back - x).max() < 2e-5
    back_j = np.asarray(pf.pifft_real(jnp.asarray(got), n))
    assert np.abs(back - back_j).max() < 2e-5
    # complex input
    xc = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    gotc = tp.pfft(torch.from_numpy(xc), n).numpy()
    assert _rel(gotc, np.fft.fft(xc.astype(np.complex128), axis=-1)[:, perm]) < 3e-6


@pytest.mark.parametrize("n", SIZES)
def test_pfft_quad_matches_two_pass_and_jax(n):
    """Fused K3 (plain version) == sum(w |pfft_stable|^2), the
    posterior-variance hot path; rows with a large mean exercise the DC term."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, n)).astype(np.float32) + 2.0
    w = (rng.random(n) + 0.1).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    two_pass = (wt * ttr.pfft_stable(xt).abs() ** 2).sum(-1).numpy()
    got = tp.pfft_quad(xt, wt, n).numpy()
    ref = np.asarray(pf.pfft_quad(jnp.asarray(x), jnp.asarray(w), n))
    assert _rel(got, two_pass) < 3e-6
    assert _rel(got, ref) < 3e-6


def test_wrappers_take_plain_path_only_on_cpu():
    """CPU tensors run the plain versions and count no launch; a tensor on
    any other non-CUDA device is refused rather than moved."""
    n = 1 << 14
    tp.reset_launches()
    x = torch.randn(2, n, generator=torch.Generator().manual_seed(1))
    tp.pfft_quad(x, torch.ones(n), n)
    tp.pifft_real(tp.pfft(x, n), n)
    tp.pifft(tp.pfft(x.to(torch.complex64), n), n)
    assert tp.launches == {"pfft": 0, "pifft_real": 0, "pifft": 0, "quad": 0}
    meta = torch.empty(1, n, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.pfft(meta, n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.pfft(meta.to(torch.complex64), n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.pifft_real(meta.to(torch.complex64), n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.pifft(meta.to(torch.complex64), n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.quad_partials(meta, torch.empty(tp._plan(n)[1], tp._plan(n)[0],
                                           tp._plan(n)[2], device="meta"), n,
                         torch.empty(1, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,R", [(1 << 14, 3), (1 << 15, 2), (1 << 17, 2), (1 << 17, 3),
                                 (1 << 19, 1), (1 << 20, 1), (1 << 20, 25), (1 << 20, 59),
                                 (1 << 21, 1), (1 << 22, 1)])
def test_kernels_match_plain_on_card(n, R):
    """K1-K3 on the card against their plain versions (float32, relative to
    the max; the kernels sum in another order than the plain matmuls): K1
    (``pfft``) on real and complex rows, K2 (``pifft_real``, and ``pifft``
    with complex output) on the spectra of both.  2^19, 2^20 and 2^21 are the sizes where the kernels' split is
    not ``_plan``'s.  K3's per-row sums are compared: the kernels give one
    partial per slab k1 <= A/2, the plain version one per k1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, n, generator=g) + 2.0
    xc = torch.complex(torch.randn(R, n, generator=g), torch.randn(R, n, generator=g))
    for rows in (x, xc):
        X = tp.pfft_plain(rows, n)
        assert _rel(tp.pfft(rows.to(dev), n).cpu().numpy(), X.numpy()) < 3e-6
        want = tp.pifft_real_plain(X, n).numpy()
        assert _rel(tp.pifft_real(X.to(dev), n).cpu().numpy(), want) < 3e-6
        want = tp.pifft_plain(X, n).numpy()
        assert _rel(tp.pifft(X.to(dev), n).cpu().numpy(), want) < 3e-6
    m = x.mean(-1)
    A, Bh, Bl, _ = tp._plan(n)
    wk = torch.rand(Bh, A, Bl, generator=g)
    q = tp.quad_partials(x.to(dev), wk.to(dev), n, m.to(dev)).sum(-1).cpu().numpy()
    assert _rel(q, tp.quad_plain(x - m[:, None], wk, n).sum(-1).numpy()) < 3e-6
