"""Port parity for the slice as a whole: posterior serving on
FastGPDigitalNetB2 through the general solver ``_FastSolver`` and the FWHT
(kernel K4's plain version on the CPU; the JAX package's XLA contraction).

* the closed-form weighted Walsh functions (ops/walsh_closed) and the DSI
  series (kernels/series) against the JAX package in float64 and float32;
* float64: the pinned golden and the JAX doctest's posterior, before and
  after the data double (the doubling-butterfly ytilde), with
  hyperparameters carried over by ``load_jax_params``;
* float32 at n = 2^14 against the JAX package in float32;
* the solver against a dense solve, and the solver routing;
* on the card: the served posterior never reaches the plain FWHT.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.kernels import series as ts  # noqa: E402
from fastgaussianprocesses_torch.models.fast import _FastSolver  # noqa: E402
from fastgaussianprocesses_torch.ops import fwht as tf  # noqa: E402
from fastgaussianprocesses_torch.ops import transforms as ttr  # noqa: E402
from fastgaussianprocesses_torch.ops import walsh_closed as twc  # noqa: E402
from fastgaussianprocesses_tpu.kernels import series as js  # noqa: E402
from fastgaussianprocesses_tpu.ops import walsh as jw  # noqa: E402
from fastgaussianprocesses_tpu.ops import walsh_closed as jwc  # noqa: E402

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)
RTOL = 1e-12
C0 = np.array([1.0, 0.5])
C1 = np.array([1.0, -2.0])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))


def _walsh_inputs(t):
    """0, 1, 2^k - 1 for every k <= t (all ones below the leading bit: a
    float32 cast rounds 2^30 - 1 up to 2^30), 2^(t-1), and random t-bit
    integers."""
    rng = np.random.default_rng(42)
    special = [0, 1, 2, 3, 1 << (t - 1)] + [(1 << k) - 1 for k in range(2, t + 1)]
    xb = np.unique(np.concatenate([np.array(special, dtype=np.uint64),
                                   rng.integers(0, 1 << t, size=300, dtype=np.uint64)]))
    return xb.astype(np.int64 if t > 30 else np.int32)


@pytest.mark.parametrize("alpha", [1, 2, 3, 4])
@pytest.mark.parametrize("t", [5, 30, 53])
def test_omega_walsh_closed_matches_jax_f64(alpha, t):
    """Float64 against the JAX closed form and the transfer recursion, at the
    JAX test's rtol 1e-12 (atol 1e-13 for values near zero)."""
    xb = _walsh_inputs(t)
    got = twc.omega_walsh_closed(torch.from_numpy(xb), t, alpha).numpy()
    np.testing.assert_allclose(got, np.asarray(jwc.omega_walsh_closed(jnp.asarray(xb), t, alpha)),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got, np.asarray(jw.omega_walsh(jnp.asarray(xb), t, alpha)),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("alpha", [1, 2, 3, 4])
@pytest.mark.parametrize("t", [5, 30])
def test_omega_walsh_closed_matches_jax_f32(alpha, t):
    """Float32 at the JAX test's tolerance against the float64 recursion
    (rtol 2e-5, atol 2e-5), and within 4 float32 ulps of the largest value
    of the JAX float32 closed form (the same operations in the same order:
    measured bitwise equal)."""
    xb = _walsh_inputs(t)
    got = twc.omega_walsh_closed(torch.from_numpy(xb), t, alpha, dtype=torch.float32).numpy()
    assert got.dtype == np.float32
    want = np.asarray(jw.omega_walsh(jnp.asarray(xb), t, alpha, dtype=jnp.float64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    j32 = np.asarray(jwc.omega_walsh_closed(jnp.asarray(xb), t, alpha, dtype=jnp.float32))
    np.testing.assert_allclose(got, j32, rtol=0, atol=4 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("alpha", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13), (torch.float32, 0)])
def test_omega_walsh_closed_pair_matches_delta_form_and_jax(alpha, dtype, rtol):
    """The side-wise pair evaluator on a (33, 1) x (1, 57) cross, the sides
    including 0 and 2^30 - 1: against the delta form (rtol 1e-13 in float64,
    the JAX test's; bitwise in float32, where both convert the same chunk
    features) and against the JAX pair evaluator (the same operations in the
    same order, measured bitwise equal: within 1e-13 in float64 and 4
    float32 ulps of the largest value, about 1, in float32)."""
    t = 30
    rng = np.random.default_rng(7)
    xa = rng.integers(0, 1 << t, size=(33, 1), dtype=np.int64).astype(np.int32)
    zb = rng.integers(0, 1 << t, size=(1, 57), dtype=np.int64).astype(np.int32)
    xa[0, 0], zb[0, 0], zb[0, 1] = 0, 0, (1 << t) - 1
    got = twc.omega_walsh_closed_pair(torch.from_numpy(xa), torch.from_numpy(zb), t, alpha,
                                      dtype=dtype).numpy()
    delta = twc.omega_walsh_closed(torch.from_numpy(xa ^ zb), t, alpha, dtype=dtype).numpy()
    np.testing.assert_allclose(got, delta, rtol=rtol, atol=rtol)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(jwc.omega_walsh_closed_pair(jnp.asarray(xa), jnp.asarray(zb), t, alpha,
                                                  dtype=jdt))
    tol = 1e-13 if dtype == torch.float64 else 4 * np.finfo(np.float32).eps
    np.testing.assert_allclose(got, want, rtol=tol if dtype == torch.float64 else 0, atol=tol)


DALPHA = np.array([2, 1, 3, 2])
DBETA0 = np.array([[0, 0, 0, 0], [1, 0, 1, 0]])
DBETA1 = np.array([[0, 0, 0, 0], [0, 0, 1, 1]])


def _digital_data(t=30):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << t, size=(5, 4), dtype=np.int64).astype(np.int32)
    z = rng.integers(0, 1 << t, size=(64, 4), dtype=np.int64).astype(np.int32)
    return x, z


def test_dsi_parts_and_fused_scan_match_jax():
    """DSI parts and the cross-kernel, with the side-wise pair evaluator and
    without, against the JAX package in float64 at rtol 1e-12."""
    t = 30
    x, z = _digital_data(t)
    scale, ls = np.array([1.7]), np.array([0.6, 1.3, 0.9, 2.1])
    delta = x[:, None, :] ^ z[None, :, :]
    for beta, kappa in [(DBETA0[0], DBETA1[0]), (DBETA0[1], DBETA1[1])]:
        got = ts.dsi_parts_from_delta(torch.from_numpy(delta), t, DALPHA, beta, kappa).numpy()
        want = np.asarray(js.dsi_parts_from_delta(jnp.asarray(delta), t, DALPHA, beta, kappa))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    part_t = lambda dl, j, b, k: ts.dsi_part_dim(dl, t, int(DALPHA[j]), b, k)
    part_j = lambda dl, j, b, k: js.dsi_part_dim(dl, t, int(DALPHA[j]), b, k)
    want = np.asarray(js.kernel_fused_scan(part_j, jnp.asarray(x[:, None, :]),
                                           jnp.asarray(z[None, :, :]), js.digital_ominus,
                                           DBETA0, DBETA1, C0, C1, jnp.asarray(scale),
                                           jnp.asarray(ls), DALPHA))

    pair_t = lambda xj, zj, j, b, k: ts.dsi_part_pair(xj, zj, t, int(DALPHA[j]), b, k)
    for pair_fn in (None, pair_t):
        got = ts.kernel_fused_scan(part_t, torch.from_numpy(x[:, None, :]),
                                   torch.from_numpy(z[None, :, :]), ts.digital_ominus, DBETA0,
                                   DBETA1, C0, C1, _t(scale), _t(ls), DALPHA,
                                   part_dim_pair_fn=pair_fn)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-14)


def _f_golden(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[:, 0]) + np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _f_doc(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _max_rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_golden_cubature_f64():
    """tests/test_goldens.py's dnb2 cm0/cv0 (seed 42, n = 64) at rtol 1e-8."""
    gp = ft.FastGPDigitalNetB2(2, seed_for_seq=42, device="cpu")
    x = gp.get_x_next(64)
    gp.add_y_next(torch.from_numpy(_f_golden(x.numpy())))
    assert isinstance(gp._solver(), _FastSolver)
    np.testing.assert_allclose(float(gp.post_cubature_mean()), 1.0074815255667824, rtol=1e-8)
    np.testing.assert_allclose(float(gp.post_cubature_var()), 0.0004126558523386281,
                               rtol=1e-8)


def _check_posterior(gt, gj, xq, future_n=None):
    pm_t, pv_t = gt.post_mean_var(xq)
    pm_j, pv_j = gj.post_mean_var(xq)
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=1e-8)
    np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j), rtol=1e-8)
    np.testing.assert_allclose(gt.post_mean(xq).numpy(), np.asarray(gj.post_mean(xq)), rtol=1e-8)
    np.testing.assert_allclose(gt.post_var(xq).numpy(), np.asarray(gj.post_var(xq)), rtol=1e-8)
    np.testing.assert_allclose(float(gt.post_cubature_mean()), float(gj.post_cubature_mean()),
                               rtol=1e-8)
    np.testing.assert_allclose(float(gt.post_cubature_var()), float(gj.post_cubature_var()),
                               rtol=1e-8)
    if future_n is not None:
        pv_future = gt.post_var(xq, n=future_n).numpy()
        np.testing.assert_allclose(pv_future, np.asarray(gj.post_var(xq, n=future_n)), rtol=1e-8)
        np.testing.assert_allclose(gt.post_mean_var(xq, n=future_n)[1].numpy(), pv_future,
                                   rtol=1e-12)
        return pm_t, pv_future
    return pm_t, None


def test_doctest_posterior_with_jax_hyperparameters_f64():
    """The digital_gp.py doctest setup: the JAX package fits, the port serves
    with the carried-over hyperparameters; every posterior agrees at rtol
    1e-8, before and after the data double from 64 to 128 points (ytilde
    then grows by the doubling butterfly), and the future-n variance at 128
    equals the variance once the 128 points are in."""
    gj = fj.FastGPDigitalNetB2(2, seed_for_seq=7, alpha=2)
    xj = np.asarray(gj.get_x_next(64))
    gj.add_y_next(jnp.asarray(_f_doc(xj)))
    gj.fit(iterations=40, verbose=0)
    gt = ft.FastGPDigitalNetB2(2, seed_for_seq=7, alpha=2, device="cpu")
    assert np.array_equal(gt.get_x_next(64).numpy(), xj)
    gt.add_y_next(torch.from_numpy(_f_doc(xj)))
    ft.load_jax_params(gt, {k: np.asarray(v) for k, v in gj._raw_dict().items()})
    xq = np.array([[0.1, 0.2], [0.5, 0.5], [0.9, 0.8]])
    pm, pv_future = _check_posterior(gt, gj, xq, future_n=128)
    np.testing.assert_allclose([round(float(v), 4) for v in pm], [0.513, 1.8084, 1.637])

    xn = np.asarray(gj.get_x_next(128))
    assert np.array_equal(gt.get_x_next(128).numpy(), xn)
    gj.add_y_next(jnp.asarray(_f_doc(xn)))
    gt.add_y_next(torch.from_numpy(_f_doc(xn)))
    assert (0, 64) in gt._ytilde_cache and (0, 128) not in gt._ytilde_cache
    merged = gt._get_ytilde(0, 128)
    np.testing.assert_allclose(merged.numpy(), ttr.ft_stable_fwht(gt.y).numpy(), rtol=0,
                               atol=1e-13)
    _check_posterior(gt, gj, xq)
    np.testing.assert_allclose(gt.post_var(xq).numpy(), pv_future, rtol=1e-8)


def _f32_pair(noise):
    n = 1 << 14
    gj = fj.FastGPDigitalNetB2(2, seed_for_seq=11, dtype=jnp.float32, noise=noise)
    gt = ft.FastGPDigitalNetB2(2, seed_for_seq=11, dtype=torch.float32, noise=noise,
                               device="cpu")
    x = np.asarray(gj.get_x_next(n))
    assert np.array_equal(gt.get_x_next(n).numpy(), x)
    y = _f_doc(x).astype(np.float32)
    gj.add_y_next(jnp.asarray(y))
    gt.add_y_next(torch.from_numpy(y))
    return gj, gt, n


@pytest.mark.parametrize("noise", [1e-8, 1.0])
def test_matches_jax_f32(noise):
    """Solver state bin for bin, then the served posterior, in float32 at
    n = 2^14, with the bounds of the lattice test
    (test_torch_lattice_gp.py::test_perm_path_matches_jax_f32): relative to
    the max, coeffs 5e-3, mean 4e-3, variance 2e-2 and cubature mean 1e-4 at
    noise 1e-8 (an ill-conditioned f32 solve), 20x tighter at noise 1.0;
    the cubature variance within 4 ulps of scale.  Measured at noise 1e-8:
    eigenvalues 0.5 ulps of the max apart, ytilde 0.25, coeffs 4.7e-4, mean
    8.7e-5, variance 8.1e-4, cubature mean 9.1e-5, cubature variance 0."""
    gj, gt, n = _f32_pair(noise)
    sj, st = gj._solver(), gt._solver()
    assert isinstance(st, _FastSolver)
    assert st.factor.lam_eff.dtype == torch.float32
    assert _max_rel(st.factor.lam_eff.numpy(), sj.factor.lam_eff) < 4 * EPS32
    assert _max_rel(gt._get_ytilde(0, n).numpy(), gj._get_ytilde(0, n)) < 4 * EPS32
    loose = 1.0 if noise < 1e-4 else 0.05
    xq = np.random.default_rng(5).uniform(size=(16, 2))
    pm_t, pv_t = gt.post_mean_var(xq)
    pm_j, pv_j = gj.post_mean_var(xq)
    assert _max_rel(gt.coeffs.numpy(), gj.coeffs) < 5e-3 * loose
    assert _max_rel(pm_t.numpy(), pm_j) < 4e-3 * loose
    assert _max_rel(pv_t.numpy(), pv_j) < 2e-2 * loose
    np.testing.assert_allclose(float(gt.post_cubature_mean()), float(gj.post_cubature_mean()),
                               rtol=1e-4 * loose)
    cv_t, cv_j = float(gt.post_cubature_var()), float(gj.post_cubature_var())
    assert abs(cv_t - cv_j) < 4 * EPS32 * float(gt.scale[0])


def test_gram_matrix_solve_matches_dense():
    """``_FastSolver.gram_matrix_solve`` against the dense Gram matrix built
    from the same kernel (float64, n = 64): K (K^-1 y) = y to 1e-10 of the
    max; noise 1e-4 bounds K's condition number (measured 5.2e-13)."""
    gp = ft.FastGPDigitalNetB2(2, seed_for_seq=3, noise=1e-4, device="cpu")
    x = gp.get_x_next(64)
    y = torch.from_numpy(_f_doc(x.numpy()))
    gp.add_y_next(y)
    xb = gp.get_xb(0)
    p = gp._transformed(gp._raw_dict())
    k = gp._kernel_explicit(xb[:, None, :], xb[None, :, :], gp.derivatives[0],
                            gp.derivatives[0], gp.derivatives_coeffs[0],
                            gp.derivatives_coeffs[0], p["scale"], p["lengthscales"])
    k = k + float(p["noise"][0]) * torch.eye(64, dtype=torch.float64)
    z = gp._solver().gram_matrix_solve(y)
    assert _max_rel((k @ z).numpy(), y.numpy()) < 1e-10


def test_single_task_lattice_at_n1_matches_jax():
    """A single-task lattice model at n = 1 has neither spectrum solver: it
    takes the general solver over the full-spectrum lattice transform
    (``_ft`` / ``_ift``), and serves as the JAX package does (float64)."""
    gt = ft.FastGPLattice(2, seed_for_seq=1, device="cpu")
    gj = fj.FastGPLattice(2, seed_for_seq=1)
    x = np.asarray(gj.get_x_next(1))
    assert np.array_equal(gt.get_x_next(1).numpy(), x)
    gt.add_y_next(torch.from_numpy(_f_doc(x)))
    gj.add_y_next(jnp.asarray(_f_doc(x)))
    assert isinstance(gt._solver(), _FastSolver)
    xq = np.random.default_rng(2).uniform(size=(5, 2))
    np.testing.assert_allclose(gt.post_mean(xq).numpy(), np.asarray(gj.post_mean(xq)), rtol=1e-8)
    np.testing.assert_allclose(gt.post_var(xq).numpy(), np.asarray(gj.post_var(xq)), rtol=1e-8)
    np.testing.assert_allclose(float(gt.post_cubature_var()), float(gj.post_cubature_var()),
                               rtol=1e-8)


@pytest.mark.cuda
def test_card_serving_never_reaches_the_plain_fwht(monkeypatch):
    """On the card every FWHT of the served posterior launches K4: with the
    plain version made to raise, a float32 model at n = 2^14 serves and
    agrees with the same model on the CPU (plain version).  Two float32
    evaluations of the posterior differ by rounding amplified by the solve:
    on the H100 this comparison measured 7.1e-5 (mean), 1.6e-3 (variance,
    which is ~1e-4 of the prior here) and 4.1e-5 (cubature mean) of the
    max, and 0 on the cubature variance; the bounds are 5x those, and 4
    float32 ulps of scale for the cubature variance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xq = np.random.default_rng(5).uniform(size=(64, 2))

    def serve(gp):
        gp.add_y_next(torch.from_numpy(_f_doc(gp.get_x_next_host(1 << 14)).astype(np.float32)))
        pm, pv = gp.post_mean_var(xq)
        return [pm.cpu().numpy(), pv.cpu().numpy(), float(gp.post_cubature_mean()),
                float(gp.post_cubature_var())]

    want = serve(ft.FastGPDigitalNetB2(2, seed_for_seq=11, dtype=torch.float32, device="cpu"))

    def refuse(x):
        raise AssertionError("the card path reached fwht_plain")

    monkeypatch.setattr(tf, "fwht_plain", refuse)
    tf.reset_launches()
    got = serve(ft.FastGPDigitalNetB2(2, seed_for_seq=11, dtype=torch.float32))
    assert tf.launches["fwht"] >= 4
    assert _max_rel(got[0], want[0]) < 4e-4
    assert _max_rel(got[1], want[1]) < 8e-3
    assert abs(got[2] / want[2] - 1) < 2e-4
    assert abs(got[3] - want[3]) < 4 * EPS32
