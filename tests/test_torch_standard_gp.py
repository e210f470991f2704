"""The port's dense ``StandardGP`` (``models/standard_gp.py``) and
``kernels/dense.py`` against the JAX package's, on the CPU in float64.

The Cholesky factor is a library call in both packages, computed by
different LAPACKs: the JAX package's CPU Cholesky is scipy's (OpenBLAS), the
port's is PyTorch's (MKL); on the same matrix they differ by a few ulps
(4.6e-14 on the golden's 64 x 64 Gram).  Quantities that cancel, like the
cubature variance (an O(1) prior minus an O(1) correction, leaving ~1.6e-6),
inherit that difference amplified; see ``test_standard_golden``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.linalg  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.kernels import dense as td  # noqa: E402
from fastgaussianprocesses_torch.models.params import IDENTITY as T_IDENTITY  # noqa: E402
from fastgaussianprocesses_tpu.kernels import dense as jd  # noqa: E402
from fastgaussianprocesses_tpu.models.params import IDENTITY as J_IDENTITY  # noqa: E402

# tests/test_goldens.py's "standard" entry
GOLDEN = dict(cm0=0.9979375388946892, cv0=1.5669409187957228e-06,
              loss0=-9673.91300128051, loss_end=110.7205753855163,
              l2=0.0023548679382318864, cm1=0.9999975973547635,
              cv1=1.700385881875377e-06)
# the cubature variance cancels an O(1) prior down to ~1.6e-6, so float64
# rounding moves it by ~1e-5 relative: it is held to the movement of the JAX
# package's own value under rounding-level changes (test_standard_golden),
# which must itself stay below this
CV_RTOL_MAX = 3e-4


def _f(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[:, 0]) + np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _golden_model():
    gp = ft.StandardGP(2, seed_for_seq=42, device="cpu")
    x = gp.get_x_next(64)
    gp.add_y_next(torch.from_numpy(_f(x)))
    return gp


def _cv_witness(jg, x, y):
    """The relative movements of the JAX package's own cubature variance
    (golden model ``jg`` at its current parameters) under rounding-level
    changes: its Cholesky factor taken from PyTorch's LAPACK (MKL) instead of
    its own (scipy's OpenBLAS; the rest of its arithmetic unchanged), the
    inverse too (PyTorch's triangular solve and product), and the same
    points and observations given in 4 other orders (``data=``)."""
    base = float(jg.post_cubature_var())
    sj = jg._solver()
    nu = max(float(jg.noise[0]), 64 * np.finfo(np.float64).eps * 64 * float(jg.scale[0]))
    gram = np.asarray(jd.dense_kernel("gaussian", jnp.asarray(x)[:, None], jnp.asarray(x)[None],
                                      np.zeros((1, 2)), np.zeros((1, 2)), [1.0], [1.0],
                                      jg.scale, jg.lengthscales)) + nu * np.eye(64)
    # the Gram rebuilt here is the one the JAX package factored, bit for bit
    assert np.array_equal(scipy.linalg.cholesky(gram, lower=True), np.asarray(sj.chol))
    chol_mkl = torch.linalg.cholesky(torch.from_numpy(gram))
    linv = jax.scipy.linalg.solve_triangular(jnp.asarray(chol_mkl.numpy()), jnp.eye(64),
                                             lower=True)
    linv_mkl = torch.linalg.solve_triangular(chol_mkl, torch.eye(64, dtype=torch.float64),
                                             upper=False)
    own = sj.thetainv
    moves = []
    for inv in (linv.T @ linv, jnp.asarray((linv_mkl.T @ linv_mkl).numpy())):
        sj.thetainv = inv
        moves.append(abs(float(jg.post_cubature_var()) - base) / base)
    sj.thetainv = own
    for seed in range(4):
        perm = np.random.default_rng(seed).permutation(64)
        jp = fj.StandardGP(2, data={"x": x[perm], "y": y[perm]})
        jp._set_raw(jg._raw_dict())
        moves.append(abs(float(jp.post_cubature_var()) - base) / base)
    return moves


def test_standard_golden():
    """``tests/test_goldens.py``'s standard golden: cubature mean, MLL loss
    history, posterior-mean error at rtol 1e-8.  The cubature variance, 1e-6
    of the prior it cancels, is held to the largest movement of the JAX
    package's own value under rounding-level changes (``_cv_witness``), before
    and after the fit; that movement stays below ``CV_RTOL_MAX``."""
    gp = _golden_model()
    jg = fj.StandardGP(2, seed_for_seq=42)
    x = np.asarray(jg.get_x_next(64))
    y = _f(x)
    jg.add_y_next(jnp.asarray(y))
    np.testing.assert_allclose(float(gp.post_cubature_mean()), GOLDEN["cm0"], rtol=1e-8)
    cv0 = float(gp.post_cubature_var())
    assert float(jg.post_cubature_var()) == GOLDEN["cv0"]
    spread0 = max(_cv_witness(jg, x, y))
    data = gp.fit(iterations=10, verbose=0, store_loss_hist=True)
    lh = data["loss_hist"]
    np.testing.assert_allclose(float(lh[0]), GOLDEN["loss0"], rtol=1e-8)
    np.testing.assert_allclose(float(lh[-1]), GOLDEN["loss_end"], rtol=1e-8)
    xq = np.random.default_rng(7).uniform(size=(128, 2))
    pm = gp.post_mean(xq).numpy()
    l2 = float(np.linalg.norm(_f(xq) - pm) / np.linalg.norm(_f(xq)))
    np.testing.assert_allclose(l2, GOLDEN["l2"], rtol=1e-8)
    np.testing.assert_allclose(float(gp.post_cubature_mean()), GOLDEN["cm1"], rtol=1e-8)
    cv1 = float(gp.post_cubature_var())
    # the witness after the fit, at the port's fitted parameters
    jg._set_raw({k: jnp.asarray(v.detach().numpy()) for k, v in gp._raw_dict().items()})
    spread1 = max(_cv_witness(jg, x, y))
    assert spread0 < CV_RTOL_MAX and spread1 < CV_RTOL_MAX, (spread0, spread1)
    np.testing.assert_allclose(cv0, GOLDEN["cv0"], rtol=spread0)
    np.testing.assert_allclose(cv1, GOLDEN["cv1"], rtol=spread1)


def test_doctest_values():
    """The values of the JAX package's ``StandardGP`` doctest."""
    gp = ft.StandardGP(2, seed_for_seq=7, device="cpu")
    x = gp.get_x_next(64)
    gp.add_y_next(torch.sin(2 * torch.pi * x[:, 0]) * torch.cos(2 * torch.pi * x[:, 1])
                  + x.sum(1))
    assert gp.fit(iterations=40, verbose=0)["iterations"] == 40
    xq = np.array([[0.1, 0.2], [0.5, 0.5], [0.9, 0.8]])
    pm, pv = gp.post_mean_var(xq)
    assert [round(float(v), 4) for v in pm] == [0.4832, 0.9991, 1.5233]
    assert round(float(gp.post_cubature_mean()), 4) == 1.0002
    pmean, pvar, q, lo, hi = gp.post_ci(xq)
    assert [round(float(v), 3) for v in lo] == [0.431, 0.957, 1.45]


@pytest.mark.parametrize("kind", td.KERNEL_CLASSES)
def test_dense_kernel_matches_jax(kind):
    """Values and derivative kernels (first, second and mixed orders, two
    weighted rows) with a parameter batch of 2, against the JAX package's
    ``jacfwd`` kernels at rtol 1e-12."""
    rng = np.random.default_rng(3)
    x0, x1 = rng.uniform(size=(5, 3)), rng.uniform(size=(4, 3))
    scale = np.array([[1.3], [0.7]])
    ls = np.array([[0.4, 0.9, 1.6], [1.1, 0.5, 0.8]])
    cases = [(np.zeros((1, 3)), np.zeros((1, 3)), [1.0], [1.0]),
             (np.array([[1, 0, 0]]), np.zeros((1, 3)), [1.0], [1.0]),
             (np.array([[0, 1, 0]]), np.array([[0, 0, 1]]), [1.0], [1.0]),
             (np.array([[2, 0, 0], [0, 1, 0]]), np.array([[1, 0, 0]]), [0.5, -1.5], [2.0])]
    # the JAX kernels of every case in one jitted call (one compile)
    wants = jax.jit(lambda a, b, s, l: [jd.dense_kernel(kind, a, b, *case, s, l)  # noqa: E731
                                        for case in cases])(
        jnp.asarray(x0)[:, None], jnp.asarray(x1)[None], jnp.asarray(scale), jnp.asarray(ls))
    for (b0, b1, c0, c1), want in zip(cases, wants):
        want = np.asarray(want)
        got = td.dense_kernel(kind, torch.from_numpy(x0)[:, None], torch.from_numpy(x1)[None],
                              b0, b1, c0, c1, torch.from_numpy(scale), torch.from_numpy(ls))
        assert got.shape == want.shape == (2, 5, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, err_msg=str((b0, b1)))


def test_derivative_informed_posterior_matches_jax():
    """(f, df/dx0) as 2 tasks (the derivative kernels in the solver and the
    cross-kernel): posterior mean against the JAX package at 1e-8 of its max,
    variance at 1e-9 of the largest prior variance it is subtracted from."""
    derivs = [np.zeros((1, 2), dtype=np.int64), np.array([[1, 0]])]
    jg = fj.StandardGP(2, num_tasks=2, seed_for_seq=5, derivatives=derivs)
    tg = ft.StandardGP(2, num_tasks=2, seed_for_seq=5, derivatives=derivs, device="cpu")
    xs = [np.asarray(x) for x in jg.get_x_next([32, 32], task=[0, 1])]
    tg.get_x_next([32, 32], task=[0, 1])
    ys = [np.sin(2 * np.pi * xs[0][:, 0]), 2 * np.pi * np.cos(2 * np.pi * xs[1][:, 0])]
    jg.add_y_next([jnp.asarray(y) for y in ys], task=[0, 1])
    tg.add_y_next([torch.from_numpy(y) for y in ys], task=[0, 1])
    xq = np.random.default_rng(2).uniform(size=(16, 2))
    pj, vj = (np.asarray(a) for a in jg.post_mean_var(xq))
    pt, vt = (a.numpy() for a in tg.post_mean_var(xq))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-8 * np.abs(pj).max())
    prior = max(float(tg.kernel(xq, xq, beta0=b, beta1=b).max()) for b in derivs)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-9 * prior)


def _escalating_pair(eps_task):
    """Both packages' 2-task GP on duplicated points whose task Gram is made
    indefinite by ``-eps_task`` on its diagonal: the Cholesky fails until the
    nugget factor has doubled enough (or 16 times)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(24, 2))
    x = np.concatenate([x, x])
    y = np.sin(x[:, 0])
    kw = dict(num_tasks=2, lengthscales=10.0, noise=1e-30, noise_task_kernel=0.0)
    tg = ft.StandardGP(2, data={"x": [x, x], "y": [y, y + 0.1]}, device="cpu",
                       tfs_noise_task_kernel=T_IDENTITY, **kw)
    jg = fj.StandardGP(2, data={"x": [x, x], "y": [jnp.asarray(y), jnp.asarray(y + 0.1)]},
                       tfs_noise_task_kernel=J_IDENTITY, **kw)
    raw = tg._raw_dict()
    raw["noise_task_kernel"] = torch.full_like(raw["noise_task_kernel"], -eps_task)
    tg._set_raw(raw)
    raw = jg._raw_dict()
    raw["noise_task_kernel"] = jnp.full_like(raw["noise_task_kernel"], -eps_task)
    jg._set_raw(raw)
    return tg, jg


@pytest.mark.parametrize("eps_task,spd", [(1e-12, 128.0), (1e-8, 65536.0)])
def test_nugget_escalation_matches_jax(eps_task, spd):
    """The nugget factor doubles as in the JAX package (128 here), and at the
    cap of 16 doublings the failed factor is NaN in both.  The escalated
    Gram's condition number is ~1 / (128 * 64 eps) ~ 5e11, so the posterior
    means are held at 5e-4 of their max."""
    tg, jg = _escalating_pair(eps_task)
    assert float(tg._solver().spd_factor) == float(jg._solver().spd_factor) == spd
    xq = np.random.default_rng(1).uniform(size=(8, 2))
    pt, pj = tg.post_mean(xq).numpy(), np.asarray(jg.post_mean(xq))
    if spd == 65536.0:
        assert np.isnan(pt).all() and np.isnan(pj).all()
    else:
        np.testing.assert_allclose(pt, pj, rtol=0, atol=5e-4 * np.abs(pj).max())


def test_cubature_closed_forms():
    """``_kint`` and ``_tprod`` (Normal-CDF and erf closed forms of the
    Gaussian kernel's integrals) against a midpoint rule, and the 2-task
    cubature mean, variance and covariance against the JAX package."""
    gp = ft.StandardGP(2, num_tasks=2, seed_for_seq=3, lengthscales=[0.3, 0.8], device="cpu")
    jg = fj.StandardGP(2, num_tasks=2, seed_for_seq=3, lengthscales=[0.3, 0.8])
    xs = [np.asarray(x) for x in jg.get_x_next([16, 8], task=[0, 1])]
    gp.get_x_next([16, 8], task=[0, 1])
    ys = [np.sin(2 * np.pi * xs[0][:, 0]), np.cos(2 * np.pi * xs[1][:, 1])]
    jg.add_y_next([jnp.asarray(y) for y in ys], task=[0, 1])
    gp.add_y_next([torch.from_numpy(y) for y in ys], task=[0, 1])
    # the kernel is a product over dimensions: 1-D midpoint rules, m = 4000
    m = 4000
    z = (np.arange(m) + 0.5) / m
    ls = gp.lengthscales.numpy()
    x0 = gp.get_x(0).numpy()
    kint = np.prod([np.exp(-(x0[:, j, None] - z) ** 2 / (2 * ls[j])).mean(-1)
                    for j in range(2)], 0)
    np.testing.assert_allclose(gp._kint(gp.n, np.array([0]))[0, :16].numpy(),
                               float(gp.gram_matrix_tasks[0, 0] * gp.scale[0]) * kint,
                               rtol=1e-6)
    tprod = np.prod([np.exp(-(z[:, None] - z[None]) ** 2 / (2 * ls[j])).mean()
                     for j in range(2)])
    np.testing.assert_allclose(float(gp._tprod()), tprod, rtol=1e-6)
    # means at 1e-8; variances and covariances cancel an O(1) prior term, so
    # they are held at 1e-9 of it (absolute; scale 1 here)
    np.testing.assert_allclose(gp.post_cubature_mean().numpy(),
                               np.asarray(jg.post_cubature_mean()), rtol=1e-8)
    for name in ("post_cubature_var", "post_cubature_cov"):
        np.testing.assert_allclose(getattr(gp, name)().numpy(), np.asarray(getattr(jg, name)()),
                                   rtol=0, atol=1e-9)


def test_data_ingestion_matches_jax():
    """``data=`` takes the user's points and observations as they are (the
    JAX package's ``_DataSeq``), refuses more points than given, and serves
    the same posterior as the JAX package; ``load_jax_params`` carries a JAX
    ``StandardGP``'s parameters (moved off their defaults) over."""
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(40, 3))
    y = np.cos(3 * x[:, 0]) + x[:, 1] * x[:, 2]
    tg = ft.StandardGP(3, data={"x": x, "y": y}, device="cpu")
    jg = fj.StandardGP(3, data={"x": x, "y": jnp.asarray(y)})
    assert tg.n.tolist() == [40]
    np.testing.assert_array_equal(tg.get_x(0).numpy(), x)
    with pytest.raises(ValueError):
        tg.get_x_next(41)
    with pytest.raises(ValueError):
        ft.StandardGP(3, num_tasks=2, data={"x": x, "y": y}, device="cpu")
    jg._set_raw({k: v + 0.25 for k, v in jg._raw_dict().items()})
    ft.load_jax_params(tg, {k: np.asarray(v) for k, v in jg._raw_dict().items()},
                       {k: p.trainable for k, p in jg.params.items()})
    xq = rng.uniform(size=(10, 3))
    (pt, vt), (pj, vj) = tg.post_mean_var(xq), jg.post_mean_var(xq)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-8)
    # variances at 1e-9 of the prior variance (the scale) they are subtracted from
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-9 * float(tg.scale[0]))


@pytest.mark.cuda
def test_card_float64_matches_cpu_float64():
    """The card's float64 StandardGP (fit, posterior, cubature) against the
    CPU's at n = 2^8: the loss history and the means within 1e-9 of their
    largest, the variances within 1e-9 of the prior variance (the scale)
    they are subtracted from; the two LAPACKs' Cholesky factors differ by
    ulps, which the Gram's conditioning amplifies (1.1e-8 elementwise on
    the smallest means on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for device in ("cpu", "cuda"):
        gp = ft.StandardGP(2, seed_for_seq=7, device=device, dtype=torch.float64)
        x = gp.get_x_next_host(256)
        gp.add_y_next(_f(x))
        loss = gp.fit(iterations=10, verbose=0, store_loss_hist=True)["loss_hist"]
        xq = np.random.default_rng(0).uniform(size=(64, 2))
        pm, pv = gp.post_mean_var(xq)
        out.append(dict(loss=np.asarray(loss), pm=pm.cpu().numpy(), pv=pv.cpu().numpy(),
                        cm=gp.post_cubature_mean().cpu().numpy(), scale=float(gp.scale[0])))
    a, b = out[1], out[0]
    for k in ("loss", "pm", "cm"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9 * np.abs(b[k]).max(), err_msg=k)
    np.testing.assert_allclose(a["pv"], b["pv"], rtol=0, atol=1e-9 * b["scale"])
