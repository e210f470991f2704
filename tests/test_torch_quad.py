"""Port parity for kernel K3's two-phase algorithm (ops/perm_fft
``quad_emulate``: the half pass A, the folded weights and the per-slab sums)
against float64 numpy and the JAX package's ``pallas_fft.pfft_quad``
(interpret mode), with the JAX package's tolerance (3e-6 of the max,
tests/test_pallas_fft.py).  The CUDA kernels themselves are held against
the plain version on the card (tests/test_torch_perm_fft.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
from fastgaussianprocesses_torch.ops import perm_fft as tp  # noqa: E402
from fastgaussianprocesses_torch.ops import si_cross as sc  # noqa: E402
from fastgaussianprocesses_tpu.ops import pallas_fft as pf  # noqa: E402

torch.set_num_threads(2)


def _rows_and_weights(n, R, seed=0):
    """Rows with mean 2.0, their centred copy and (Bh, A, Bl) weights with
    the DC weight zeroed, as ``pfft_quad`` hands them to the kernel."""
    A, Bh, Bl, _ = tp._plan(n)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, n)) + 2.0
    xm = x - x.mean(-1, keepdims=True)
    wk = (rng.random(n) + 0.1).reshape(Bh, A, Bl)
    wk.reshape(-1)[0] = 0.0
    return x, xm, wk


def _numpy_quad(xm, wk, n):
    """sum_k w_k |FFT(xm)_k|^2 per row in float64, weights in natural order."""
    w_nat = np.empty(n)
    w_nat[tp.spectrum_perm(n)] = wk.reshape(-1)
    return (w_nat * np.abs(np.fft.fft(xm, axis=-1)) ** 2).sum(-1)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 17])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-6), (torch.float64, 1e-12)])
def test_quad_emulate_matches_numpy(n, dtype, tol):
    """The two-phase algorithm (K3's split A = 128 at 2^14 and 2^15, 64 at
    2^17; first Stockham radix 8, 16 and 8), centring rows of mean 2.0 as
    it loads them, against float64 numpy: float32 at the JAX package's
    tolerance, float64 to 1e-12."""
    x, xm, wk = _rows_and_weights(n, 3)
    xt = torch.from_numpy(x).to(dtype)
    got = tp.quad_emulate(xt, torch.from_numpy(wk).to(dtype), n, xt.mean(-1))
    A = tp._slab_plan(n)[0]
    assert got.shape == (3, A // 2 + 1) and got.dtype == dtype
    assert _rel(got.sum(-1).double().numpy(), _numpy_quad(xm, wk, n)) < tol


@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
def test_pfft_quad_through_emulation_matches_jax(n, monkeypatch):
    """``pfft_quad`` with its kernel replaced by the emulation (float32)
    against the JAX package's Pallas kernel in interpret mode and the plain
    version; rows with a large mean exercise the stabilized DC term."""
    x, _, _ = _rows_and_weights(n, 3)
    x = x.astype(np.float32)
    w = (np.random.default_rng(1).random(n) + 0.1).astype(np.float32)
    want = tp.pfft_quad(torch.from_numpy(x), torch.from_numpy(w), n).numpy()
    ref = np.asarray(pf.pfft_quad(jnp.asarray(x), jnp.asarray(w), n))
    monkeypatch.setattr(tp, "quad_partials", tp.quad_emulate)
    got = tp.pfft_quad(torch.from_numpy(x), torch.from_numpy(w), n).numpy()
    assert _rel(got, ref) < 3e-6
    assert _rel(got, want) < 3e-6


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 17, 1 << 20])
def test_fold_weights_sum_over_half_slabs(n):
    """The fold alone, in float64: the weighted sum over every bin equals the
    sum over the slabs k1 <= A/2 with the folded weights; the zeroed DC
    weight stays zero, and slabs 0 and A/2 are not folded.  K3's split has
    A = 128 at 2^14 and 2^15, 64 at 2^17 and 256 at 2^20."""
    A = tp._slab_plan(n)[0]
    _, xm, wk = _rows_and_weights(n, 1)
    wf = tp.fold_weights(torch.from_numpy(wk), n).numpy()
    assert wf.shape == (A // 2 + 1, n // A)
    assert wf[0, 0] == 0.0
    X = np.abs(np.fft.fft(xm[0])) ** 2
    half = X.reshape(n // A, A).T[:A // 2 + 1]        # [k1, k2] = |X_{k1 + A k2}|^2
    assert abs((wf * half).sum() / _numpy_quad(xm, wk, n)[0] - 1) < 1e-12
    w_nat = np.empty(n)
    w_nat[tp.spectrum_perm(n)] = wk.reshape(-1)
    w_slab = w_nat.reshape(n // A, A).T
    assert np.array_equal(wf[[0, A // 2]], w_slab[[0, A // 2]])


@pytest.mark.parametrize("n", [1 << 16, 1 << 20])
def test_half_pass_a_matches_direct_dft(n):
    """Phase 1 alone at the splits the other tests miss (A = 128 with a
    radix-2 first Stockham pass at 2^16; A = 256, B = 2^12 at 2^20, the
    main path's) against the direct length-A DFT in float64, slabs
    k1 = 0..A/2 only; then the whole emulation at 2^16."""
    A = tp._slab_plan(n)[0]
    x = np.random.default_rng(2).standard_normal((1, n))
    got = tp.pass_a_emulate(torch.from_numpy(x), n, half=True).numpy()
    F = np.exp(-2j * np.pi * np.outer(np.arange(A // 2 + 1), np.arange(A)) / A)
    want = np.einsum("ka,rab->rkb", F, x.reshape(1, A, n // A))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-13
    if n == 1 << 16:
        x, xm, wk = _rows_and_weights(n, 2)
        got = tp.quad_emulate(torch.from_numpy(x), torch.from_numpy(wk), n,
                              torch.from_numpy(x.mean(-1)))
        assert _rel(got.sum(-1).numpy(), _numpy_quad(xm, wk, n)) < 1e-12


@pytest.mark.cuda
def test_card_quad_never_reaches_plain_or_emulation(monkeypatch):
    """On the card K3 launches its two kernels: with the plain version and
    the emulation made to raise, ``pfft_quad`` agrees with float64 numpy
    (3e-6 of the max) at n = 2^15 and 2^20, and a served float32 lattice
    posterior variance at n = 2^14 agrees with the same model's CPU float32
    run through the plain kernels.  The variance here is ~7e-4 of a prior of
    order 1, so float32 rounding of the prior minus the quadratic form
    shows: on the H100 the two differed by 2.8e-3 of the max (~16 float32
    ulps of the prior); the bound is 5x that.  That comparison holds K3
    alone, so the card's model there computes its cross-kernel with the
    loop, as the CPU's does.  Through kernel K5 (ops/si_cross), which folds
    the series into one polynomial, the cross-kernel rounds otherwise, and a
    variance that float32 does not resolve (the float64 model's is ~220
    times smaller) moves with it: the card's served variance through K5 is
    held against the CPU's float64 loop, no further from it than the CPU's
    float32 run is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.setenv("FASTGPS_TORCH_FORCE_PERM", "1")
    xq = np.random.default_rng(5).uniform(size=(64, 2))

    def served_var(dev, dtype=torch.float32, k5=True):
        gp = ft.FastGPLattice(2, seed_for_seq=11, dtype=dtype, device=dev)
        if not k5:
            gp._bernoulli_series = False
        x = gp.get_x_next_host(1 << 14)
        gp.add_y_next(torch.from_numpy((np.sin(2 * np.pi * x[:, 0]) + x.sum(1)).astype(np.float32)))
        return gp.post_var(xq).cpu().numpy()

    want_var = served_var("cpu")
    want64 = served_var("cpu", torch.float64)

    def refuse(*a, **k):
        raise AssertionError("the card path reached a plain version of K3")

    for name in ("quad_plain", "quad_emulate", "pass_a_emulate", "quad_slab_sums", "slab_dft"):
        monkeypatch.setattr(tp, name, refuse)
    tp.reset_launches()
    for n, R in [(1 << 15, 2), (1 << 20, 3)]:
        x, _, _ = _rows_and_weights(n, R)
        w = np.random.default_rng(3).random(n) + 0.1
        got = tp.pfft_quad(torch.from_numpy(x).float().cuda(), torch.from_numpy(w).float().cuda(),
                           n).cpu().numpy()
        xm = x - x.mean(-1, keepdims=True)
        sp = np.fft.fft(xm, axis=-1)[:, tp.spectrum_perm(n)] / np.sqrt(n)
        sp[:, 0] += x.mean(-1) * np.sqrt(n)
        assert _rel(got, (w * np.abs(sp) ** 2).sum(-1)) < 3e-6
    assert tp.launches["quad"] == 2
    assert _rel(served_var("cuda", k5=False), want_var) < 1.4e-2
    assert tp.launches["quad"] >= 3
    sc.reset_launches()
    got = served_var("cuda")
    assert sc.launches["si_cross"] >= 1
    assert _rel(got, want64) <= _rel(want_var, want64)
