"""Port parity for the rest of serving: ``post_cov`` (its two-level tiling,
the diagonal clamp, future-n projections, fleets x tasks), ``post_error``,
``post_ci``, ``post_cubature_error`` and ``post_cubature_ci`` (the JAX
package's q^2 semantics of ``post_ci``), float64 on the CPU, against the
port's dense oracle and the JAX package; and ``FASTGPS_TORCH_DEBUG``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.models import abstract as tabs  # noqa: E402
from fastgaussianprocesses_torch.utils import debug as tdebug  # noqa: E402
from fastgaussianprocesses_torch.utils.debug import dense_gram  # noqa: E402

torch.set_num_threads(2)

NAMES = ("FastGPLattice", "FastGPDigitalNetB2")


def f_ackley(x, a=20, b=0.2, c=2 * np.pi, scaling=32.768):
    x = 2 * scaling * np.asarray(x) - scaling
    t1 = a * np.exp(-b * np.sqrt(np.mean(x**2, -1)))
    t2 = np.exp(np.mean(np.cos(c * x), -1))
    return -(t1 + t2) + a + np.e


def _make(name, n, **kw):
    gp = getattr(ft, name)(2, seed_for_seq=7, device="cpu", **kw)
    gp.add_y_next(torch.from_numpy(f_ackley(gp.get_x_next_host(n))))
    return gp


def _inv(K):
    # torch's LAPACK: numpy's OpenBLAS threads stall behind torch's
    return torch.linalg.inv(torch.from_numpy(K)).numpy()


def _k(gp, a, b):
    return gp.kernel(torch.as_tensor(a)[:, None, :], torch.as_tensor(b)[None, :, :]).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_post_var_cov_match_dense(name):
    """The JAX package's ``test_post_var_cov_match_dense``: variance and
    covariance against the dense formulas (atol 1e-6), the covariance of a
    set with itself has the variance on its diagonal (atol 1e-8)."""
    gp = _make(name, 64, noise=1e-4)
    rng = np.random.default_rng(3)
    x, z = rng.uniform(size=(9, 2)), rng.uniform(size=(7, 2))
    Ki = _inv(dense_gram(gp))
    xb = gp.get_xb(0).numpy()
    kx, kz = _k(gp, x, xb), _k(gp, z, xb)
    want_cov = _k(gp, x, z) - kx @ Ki @ kz.T
    pvar = gp.post_var(x).numpy()
    np.testing.assert_allclose(pvar, np.diag(_k(gp, x, x) - kx @ Ki @ kx.T), atol=1e-6)
    np.testing.assert_allclose(gp.post_cov(x, z).numpy(), want_cov, atol=1e-6)
    np.testing.assert_allclose(gp.post_cov(x, x).numpy().diagonal(), pvar, atol=1e-8)


@pytest.mark.parametrize("name", NAMES)
def test_post_cov_future_n_equals_after_ingesting(name):
    """``post_cov`` projected to 2n equals the covariance after the points
    are added (atol 1e-10), as the JAX package's ``test_future_n_projections``
    holds it."""
    n = 64
    gp = _make(name, n)
    rng = np.random.default_rng(11)
    x, z = rng.uniform(size=(8, 2)), rng.uniform(size=(6, 2))
    pcov_f = gp.post_cov(x, z, n=2 * n).numpy()
    gp.add_y_next(torch.from_numpy(f_ackley(gp.get_x_next_host(2 * n))))
    np.testing.assert_allclose(gp.post_cov(x, z).numpy(), pcov_f, atol=1e-10)


def test_post_cov_tiling_matches_one_shot():
    """With the query budget cut so that both levels tile (x1 blocks of 3
    rows solved a row at a time, x0 chunks of one row), a two-task
    covariance equals the untiled one (rtol 1e-12, atol 1e-13: entries of
    order 1 and the FFTs of a chunk round by its row count), and the diagonal
    clamp of a set with itself leaves no negative variance."""
    gp = ft.FastGPLattice(2, num_tasks=2, seed_for_seq=7, noise=1e-6, device="cpu")
    xs = gp.get_x_next_host([32, 16], task=[0, 1])
    gp.add_y_next([torch.from_numpy(f_ackley(x)) for x in xs], task=[0, 1])
    x = np.random.default_rng(2).uniform(size=(7, 2))
    x[3] = xs[0][5]       # a training point: its variance is ~0 and may round below
    z = np.random.default_rng(3).uniform(size=(5, 2))
    whole_xz, whole_xx = gp.post_cov(x, z), gp.post_cov(x, x)
    # a third of the budget holds 3 solved rows of both tasks (8-byte floats),
    # less than one row of the live cross-kernel chunk
    gp._QUERY_CHUNK_BYTES = 3 * (3 * 2 * int(gp.n.sum()) * 8)
    np.testing.assert_allclose(gp.post_cov(x, z).numpy(), whole_xz.numpy(), rtol=1e-12,
                               atol=1e-13)
    tiled_xx = gp.post_cov(x, x)
    np.testing.assert_allclose(tiled_xx.numpy(), whole_xx.numpy(), rtol=1e-12, atol=1e-13)
    for t in range(2):
        assert (torch.diagonal(tiled_xx[t, t]) >= 0).all()


def test_post_cov_fleet_by_tasks():
    """A 2-member fleet of a 2-task lattice (the JAX package's
    ``test_batched_multitask_combined``): ``post_cov`` is (B, T, T, N, N)
    with each (t, t) diagonal equal to ``post_var`` (rtol 1e-10), and
    ``post_cubature_cov`` is (B, T, T) with the cubature variances on its
    diagonal."""
    B = 2
    gp = ft.FastGPLattice(2, num_tasks=2, seed_for_seq=7, shape_batch=(B,),
                          shape_lengthscales=(B, 2), lengthscales=np.array([[0.8, 1.2], [1.5, 0.6]]),
                          device="cpu")
    xs = gp.get_x_next_host([32, 16], task=[0, 1])
    gp.add_y_next([torch.from_numpy(np.stack([f_ackley(xs[0])] * B)),
                   torch.from_numpy(np.stack([f_ackley(xs[1]) * 0.5] * B))], task=[0, 1])
    x = xs[1][:4]
    pc = gp.post_cov(x, x)
    assert pc.shape == (B, 2, 2, 4, 4)
    pv = gp.post_var(x)
    for t in range(2):
        np.testing.assert_allclose(torch.diagonal(pc[:, t, t], dim1=-2, dim2=-1).numpy(),
                                   pv[:, t].numpy(), rtol=1e-10, atol=1e-14)
    pcc = gp.post_cubature_cov()
    assert pcc.shape == (B, 2, 2)
    np.testing.assert_allclose(torch.diagonal(pcc, dim1=-2, dim2=-1).numpy(),
                               gp.post_cubature_var().numpy(), rtol=1e-10)


@pytest.mark.parametrize("name", NAMES)
def test_errors_and_credible_intervals(name):
    """``post_error`` and ``post_cubature_error`` are ``(var, q, q *
    sqrt(var))`` of the port's own variances; ``post_ci`` has the half-width
    ``q * perror`` with ``perror = q * sqrt(pvar)`` (the JAX package's
    semantics) and ``post_cubature_ci`` ``q * sqrt(pcvar)``, at confidence
    0.9 (rtol 1e-12); a confidence outside (0, 1) raises."""
    gp = _make(name, 64, noise=1e-4)
    x = np.random.default_rng(4).uniform(size=(5, 2))
    q = tabs.norm_ppf(0.95)
    pv = gp.post_var(x).numpy()
    pm = gp.post_mean(x).numpy()
    pcm, pcv = float(gp.post_cubature_mean()), float(gp.post_cubature_var())
    want = {"post_error": (pv, q, q * np.sqrt(pv)),
            "post_ci": (pm, pv, q, pm - q * q * np.sqrt(pv), pm + q * q * np.sqrt(pv)),
            "post_cubature_error": (pcv, q, q * np.sqrt(pcv)),
            "post_cubature_ci": (pcm, pcv, q, pcm - q * np.sqrt(pcv), pcm + q * np.sqrt(pcv))}
    for fn, vals in want.items():
        args = (x,) if fn in ("post_error", "post_ci") else ()
        for a, b in zip(getattr(gp, fn)(*args, confidence=0.9), vals):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-12, atol=1e-15, err_msg=fn)
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError, match="confidence"):
            gp.post_ci(x, confidence=bad)


def test_credible_interval_matches_jax():
    """``post_ci`` of the lattice against the JAX package at rtol 1e-8 (the
    default confidence 0.99)."""
    gt = _make("FastGPLattice", 64, noise=1e-4)
    gj = fj.FastGPLattice(2, seed_for_seq=7, noise=1e-4)
    gj.add_y_next(jnp.asarray(f_ackley(gj.get_x_next_host(64))))
    x = np.random.default_rng(4).uniform(size=(5, 2))
    for a, b in zip(gt.post_ci(x), gj.post_ci(x)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-14)


def test_norm_ppf():
    np.testing.assert_allclose(tabs.norm_ppf(0.995), 2.5758293035489004, rtol=1e-15)
    np.testing.assert_allclose(tabs.norm_ppf(0.5), 0.0, atol=1e-15)


def test_debug_flag_checks_every_new_solver(monkeypatch):
    """``FASTGPS_TORCH_DEBUG=1``: a single-task lattice takes the general
    solver (not the half spectrum) and each solver a model caches (the
    cubature's, as in the JAX package) passes the dense oracle; a solver that
    disagrees with it raises."""
    monkeypatch.setenv("FASTGPS_TORCH_DEBUG", "1")
    checked = []
    check = tdebug.check_fast_solver
    monkeypatch.setattr(tdebug, "check_fast_solver",
                        lambda m, s: checked.append(type(s).__name__) or check(m, s))
    gp = ft.FastGPLattice(2, num_tasks=2, seed_for_seq=1, noise=1e-4, device="cpu")
    xs = gp.get_x_next_host([16, 8], task=[0, 1])
    gp.add_y_next([torch.from_numpy(f_ackley(x)) for x in xs], task=[0, 1])
    gp.post_cubature_var()
    gp.post_cubature_var(n=[32, 8])
    one = _make("FastGPLattice", 32, noise=1e-4)
    one.post_cubature_var()
    assert checked == ["_FastSolver"] * 3
    solver = one._solver()
    solver.factor = solver.factor._replace(logdet=solver.factor.logdet + 1.0)
    with pytest.raises(AssertionError, match="logdet"):
        check(one, solver)
