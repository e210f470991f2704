"""Port parity for multitask fast GPs: the residue-block solver
(``linalg/fast_solver``) behind ``_FastSolver`` on FastGPLattice and
FastGPDigitalNetB2, in float64 on the CPU.

* against the port's dense oracle (``utils/debug.dense_gram``): the ``ns``
  cases of the JAX package's ``test_multitask_matches_dense`` at its
  tolerances (the closed forms, the Schur ladder, tasks with n = 1), M = 17
  and 32 (the deep Schur ladder), M = 65 (LU), the cubature and the exact
  inverse diagonal;
* against the JAX package at rtol 1e-8, with the same hyperparameters: the
  coefficients, the MLL with its norm and log-determinant terms and its
  gradient, 10-step loss histories of MLL, GCV and CV, ``post_mean_var``,
  ``post_cov``, ``post_ci`` and ``post_cubature_cov`` at M = 3 (the closed
  form), and the MLL and its gradient through the complex Schur ladder at
  M = 5.  (The JAX package compiles a multitask fit at M = 7 for minutes on
  the CPU, so the tests stop at M = 5; ``chip_smoke.py`` runs M = 7 on the
  card.)
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.models.fast import _FastSolver  # noqa: E402
from fastgaussianprocesses_torch.utils.debug import dense_gram  # noqa: E402

torch.set_num_threads(2)

NAMES = ("FastGPLattice", "FastGPDigitalNetB2")


def f_ackley(x, a=20, b=0.2, c=2 * np.pi, scaling=32.768):
    x = 2 * scaling * np.asarray(x) - scaling
    t1 = a * np.exp(-b * np.sqrt(np.mean(x**2, -1)))
    t2 = np.exp(np.mean(np.cos(c * x), -1))
    return -(t1 + t2) + a + np.e


def _make(name, ns, **kw):
    """The port's model on the CPU in float64 with ``f_ackley`` data, as the
    JAX package's ``tests/test_fast_gp.py:_make`` builds it."""
    T = len(ns)
    gp = getattr(ft, name)(2, num_tasks=T, seed_for_seq=7, device="cpu", **kw)
    xs = gp.get_x_next_host(list(ns), task=list(range(T)))
    gp.add_y_next([torch.from_numpy(f_ackley(x)) for x in xs], task=list(range(T)))
    return gp


# dense linear algebra through torch: numpy's OpenBLAS threads stall behind the
# threads torch has just used (a 176 x 176 inverse measured 2.3 s in this file)
def _solve(K, y):
    return torch.linalg.solve(torch.from_numpy(K), torch.from_numpy(y)).numpy()


def _logdet(K):
    return float(torch.linalg.slogdet(torch.from_numpy(K)).logabsdet)


def _inv(K):
    return torch.linalg.inv(torch.from_numpy(K)).numpy()


def _y(gp):
    return np.concatenate([gp._y[l].numpy() for l in range(gp.num_tasks)])


def _kx(gp, x, t):
    """Dense cross-covariance of task t at the points x against the training
    set (task Gram included)."""
    S = gp.gram_matrix_tasks.numpy()
    return np.concatenate([S[t, l] * gp.kernel(torch.from_numpy(x)[:, None, :],
                                               gp.get_xb(l)[None, :, :]).numpy()
                           for l in range(gp.num_tasks)], -1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ns", [[16, 16], [64, 16], [64, 16, 4], [16, 16, 16], [128, 16, 16, 16],
                                [64, 1], [1, 64], [16, 4, 1]])
def test_multitask_matches_dense(name, ns):
    """The JAX package's cases and tolerances: coefficients atol 1e-6,
    log-determinant rtol 1e-7, posterior mean and variance atol 1e-8.  The
    n = 1 tasks are its regression for a mixed per-task column order."""
    gp = _make(name, ns, noise=1e-4)
    K = dense_gram(gp)
    want = _solve(K, _y(gp))
    np.testing.assert_allclose(gp.coeffs.numpy(), want, atol=1e-6)
    assert isinstance(gp._solver(), _FastSolver)
    logdet = _logdet(K)
    np.testing.assert_allclose(float(gp._solver().factor.logdet), logdet, rtol=1e-7)
    x = np.random.default_rng(23).uniform(size=(5, 2))
    kx = _kx(gp, x, 0)
    np.testing.assert_allclose(gp.post_mean(x, task=0).numpy(), kx @ want, atol=1e-8)
    S00 = gp.gram_matrix_tasks.numpy()[0, 0]
    kxx = S00 * gp.kernel(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    want_pv = kxx - np.einsum("ni,ij,nj->n", kx, _inv(K), kx)
    np.testing.assert_allclose(gp.post_var(x, task=0).numpy(), np.maximum(want_pv, 0), atol=1e-8)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T,nper", [(17, 16), (32, 8)])
def test_multitask_deep_schur_ladder_matches_dense(name, T, nper):
    """M = 17 and 32 residue blocks through the recursive Schur ladder, at
    the JAX package's tolerances (coefficients atol 1e-5, log-determinant
    rtol 1e-6: about one digit lost a level against pivoted LU)."""
    gp = _make(name, [nper] * T, noise=1e-4)
    K = dense_gram(gp)
    np.testing.assert_allclose(gp.coeffs.numpy(), _solve(K, _y(gp)), atol=1e-5)
    logdet = _logdet(K)
    np.testing.assert_allclose(float(gp._solver().factor.logdet), logdet, rtol=1e-6)


def test_multitask_above_schur_ceiling_matches_dense():
    """M = 65 > 64: complex LU on the lattice's blocks (coefficients atol
    1e-6, log-determinant rtol 1e-7)."""
    gp = _make("FastGPLattice", [4] * 65, noise=1e-4)
    assert gp._solver().factor.inv.shape[-1] == 65
    K = dense_gram(gp)
    np.testing.assert_allclose(gp.coeffs.numpy(), _solve(K, _y(gp)), atol=1e-6)
    logdet = _logdet(K)
    np.testing.assert_allclose(float(gp._solver().factor.logdet), logdet, rtol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_multitask_cubature_and_inv_diag_match_dense(name):
    """Cubature variance and covariance between tasks (rtol 1e-6), the
    cubature mean (rtol 1e-8) and the exact diagonal of K^-1 (rtol 1e-6)."""
    ns = [32, 8]
    gp = _make(name, ns, noise=1e-4)
    K = dense_gram(gp)
    S = gp.gram_matrix_tasks.numpy()
    scale = float(gp.scale[0])
    kint = [np.concatenate([S[t, l] * scale * np.ones(ns[l]) for l in range(2)]) for t in (0, 1)]
    want_var0 = scale * S[0, 0] - kint[0] @ _solve(K, kint[0])
    got = gp.post_cubature_var(task=[0, 1]).numpy()
    np.testing.assert_allclose(got[0], max(want_var0, 0.0), rtol=1e-6, atol=1e-12)
    want_cov = scale * S[0, 1] - kint[0] @ _solve(K, kint[1])
    got_cov = gp.post_cubature_cov(task0=[0], task1=[1]).numpy()
    np.testing.assert_allclose(got_cov[0, 0], want_cov, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(gp.post_cubature_cov(task0=0, task1=1)), want_cov,
                               rtol=1e-6, atol=1e-12)
    want_mean = kint[0] @ _solve(K, _y(gp))
    np.testing.assert_allclose(float(gp.post_cubature_mean(task=0)), want_mean, rtol=1e-8)
    np.testing.assert_allclose(gp._solver().inv_diag().numpy(), np.diag(_inv(K)),
                               rtol=1e-6)


def _jax_pair(name, ns, seed=3):
    """The port's model and the JAX package's on the same points and data,
    with the same hyperparameters from a seed (lengthscales, task factor and
    noise)."""
    rng = np.random.default_rng(seed)
    T = len(ns)
    kw = dict(lengthscales=rng.uniform(0.5, 1.5, 2), factor_task_kernel=rng.uniform(0.5, 1.5, (T, 1)),
              noise_task_kernel=rng.uniform(0.1, 0.5, T), noise=1e-3)
    gj = getattr(fj, name)(2, num_tasks=T, seed_for_seq=7, **kw)
    xs = gj.get_x_next_host(list(ns), task=list(range(T)))
    ys = [f_ackley(x) for x in xs]
    gj.add_y_next([jnp.asarray(y) for y in ys], task=list(range(T)))
    gt = _make(name, ns, **kw)
    for l in range(T):
        assert np.array_equal(gt._y[l].numpy(), ys[l])
    return gt, gj


def _loss_and_grad_pair(gt, gj, metric="MLL"):
    const = float(gt.n.sum()) * math.log(2 * math.pi)
    lt = gt._make_loss_fn(metric, None, 1, const, 1)
    loss_t, terms_t, grads_t = lt(gt._raw_dict(), gt._fit_data())
    lj = gj._make_loss_fn(metric, None, 1, const, 1)
    (loss_j, terms_j), grads_j = lj(gj._raw_dict(), gj._fit_data())
    return (loss_t, terms_t, grads_t), (loss_j, terms_j, grads_j)


def _assert_loss_and_grad(gt, gj):
    """The MLL, its two terms (the norm and the log-determinant) and every
    trained parameter's gradient at rtol 1e-8 (the gradient's atol 1e-8 of
    its largest entry)."""
    (loss_t, terms_t, grads_t), (loss_j, terms_j, grads_j) = _loss_and_grad_pair(gt, gj)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-8)
    for a, b in zip(terms_t, terms_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-8)
    trained = [k for k, p in gt.params.items() if p.trainable]
    assert set(trained) == {"scale", "lengthscales", "factor_task_kernel", "noise_task_kernel"}
    for k in trained:
        want = np.asarray(grads_j[k])
        np.testing.assert_allclose(grads_t[k].numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(), err_msg=k)


@pytest.fixture(scope="module", params=NAMES)
def m3_pair(request):
    return _jax_pair(request.param, [16, 8])


def test_m3_served_posterior_matches_jax(m3_pair):
    """M = 3: coefficients, ``post_mean_var``, ``post_ci``, ``post_cov`` of a
    set with itself (its diagonal clamped) and, for the lattice,
    ``post_cubature_cov`` at rtol 1e-8 (atol 1e-12 for entries near 0)."""
    gt, gj = m3_pair
    assert gt._solver().factor.inv.shape[-2:] == (3, 3)
    close = dict(rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gt.coeffs.numpy(), np.asarray(gj.coeffs), **close)
    x = np.random.default_rng(5).uniform(size=(6, 2))
    for a, b in zip(gt.post_mean_var(x), gj.post_mean_var(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
    for a, b in zip(gt.post_ci(x), gj.post_ci(x)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **close)
    pxx = gt.post_cov(x, x)
    np.testing.assert_allclose(pxx.numpy(), np.asarray(gj.post_cov(x, x)), **close)
    np.testing.assert_allclose(torch.diagonal(pxx[1, 1]).numpy(), gt.post_var(x, task=1).numpy(),
                               rtol=1e-10, atol=1e-12)
    if isinstance(gt, ft.FastGPLattice):  # the digital net's: dense-oracle test above
        np.testing.assert_allclose(gt.post_cubature_cov().numpy(),
                                   np.asarray(gj.post_cubature_cov()), **close)


def test_m3_mll_and_gradient_match_jax(m3_pair):
    _assert_loss_and_grad(*m3_pair)


@pytest.mark.parametrize("name,metric", [("FastGPLattice", "MLL"), ("FastGPLattice", "GCV"),
                                         ("FastGPDigitalNetB2", "CV")])
def test_m3_fit_histories_match_jax(name, metric):
    """10 Rprop steps of each loss from the same start: the loss histories
    and the fitted task Gram at rtol 1e-8 (each metric once: the MLL and
    GCV terms are model-independent above the transforms, and the digital
    net's CV reads the Walsh characters of the exact inverse diagonal)."""
    gt, gj = _jax_pair(name, [16, 8])
    dt = gt.fit(loss_metric=metric, iterations=10, verbose=0, store_loss_hist=True)
    dj = gj.fit(loss_metric=metric, iterations=10, verbose=0, store_loss_hist=True)
    assert dt["iterations"] == dj["iterations"]
    np.testing.assert_allclose(dt["loss_hist"], np.asarray(dj["loss_hist"]), rtol=1e-8)
    np.testing.assert_allclose(gt.gram_matrix_tasks.numpy(), np.asarray(gj.gram_matrix_tasks),
                               rtol=1e-8)


def test_m5_complex_schur_ladder_mll_and_gradient_match_jax():
    """M = 5 on the lattice (ns = [16, 4]: r = (4, 1)), the complex Hermitian
    blocks through one Schur level (a 2 x 2 and a 3 x 3 closed form): the
    MLL, its terms and its gradient against ``jax.grad`` at rtol 1e-8."""
    gt, gj = _jax_pair("FastGPLattice", [16, 4])
    assert gt._solver().factor.inv.shape[-2:] == (5, 5)
    assert gt._solver().factor.inv.is_complex()
    _assert_loss_and_grad(gt, gj)
