"""Port parity for derivative-informed fast GPs, ``adaptive_nugget`` and
batch fleets (``shape_batch``, ``fit(masks=...)``), float64 on the CPU, and
the row tiling of kernels K1-K3.

* derivative-informed and weighted multi-row derivative models against the
  port's dense oracle, at the JAX package's tolerances
  (``tests/test_derivatives_and_batch.py:28-62, :189``), and one against the
  JAX package's MLL and gradient;
* ``adaptive_nugget`` against the dense oracle and the JAX package;
* fleets and masks against the JAX package at rtol 1e-8 (``:82-114,
  :151-187``), and a fleet member against the same model alone;
* the float32 permuted path of a lattice fleet (K3 once per member) against
  the members' own models;
* K1-K3 launched in row blocks of at most ``perm_fft.MAX_GRID_ROWS`` (CUDA
  caps ``gridDim.y``, which carries the row, at 65535): the block plan, the
  emulations block by block, and on the card the kernels at a lowered cap.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.ops import perm_fft as tp  # noqa: E402
from fastgaussianprocesses_torch.utils.debug import dense_gram  # noqa: E402

torch.set_num_threads(2)


def f_poly(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def df_dx0(x):
    x = np.asarray(x)
    return 2 * np.pi * np.cos(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def df_dx1(x):
    x = np.asarray(x)
    return -2 * np.pi * np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1])


# dense linear algebra through torch (numpy's OpenBLAS threads stall behind
# the threads torch has just used)
def _solve(K, y):
    return torch.linalg.solve(torch.from_numpy(K), torch.from_numpy(y)).numpy()


def _logdet(K):
    return float(torch.linalg.slogdet(torch.from_numpy(K)).logabsdet)


def _min_eig(K):
    return float(torch.linalg.eigvalsh(torch.from_numpy((K + K.T) / 2)).min())


def _check_dense(gp, ys, task, xq, atol_c, atol_pm):
    """Coefficients (``atol_c``), log-determinant (rtol 1e-6) and the
    posterior mean of ``task`` at ``xq`` (``atol_pm``) against the dense
    oracle, which must be positive definite."""
    K = dense_gram(gp)
    assert _min_eig(K) > 0
    y = np.concatenate(ys)
    want = _solve(K, y)
    np.testing.assert_allclose(gp.coeffs.numpy(), want, atol=atol_c)
    np.testing.assert_allclose(float(gp._solver().factor.logdet), _logdet(K), rtol=1e-6)
    kx = np.concatenate([gp._kernel_explicit(
        torch.from_numpy(xq)[:, None, :], gp.get_xb(l)[None, :, :],
        gp.derivatives[task], gp.derivatives[l], gp.derivatives_coeffs[task],
        gp.derivatives_coeffs[l], gp.scale, gp.lengthscales).numpy()
        for l in range(gp.num_tasks)], -1)
    np.testing.assert_allclose(gp.post_mean(xq, task=task).numpy(), kx @ want, atol=atol_pm)


def _deriv_model(lib, name, **kw):
    d = 2
    derivs = [np.zeros((1, d), dtype=np.int64), np.array([[1, 0]]), np.array([[0, 1]])]
    extra = {} if lib is fj else {"device": "cpu"}
    gp = getattr(lib, name)(d, num_tasks=3, seed_for_seq=5, derivatives=derivs, noise=1e-4,
                            **kw, **extra)
    xs = gp.get_x_next_host([32, 16, 16], task=[0, 1, 2])
    ys = [f_poly(xs[0]), df_dx0(xs[1]), df_dx1(xs[2])]
    wrap = jnp.asarray if lib is fj else torch.from_numpy
    gp.add_y_next([wrap(y) for y in ys], task=[0, 1, 2])
    return gp, ys


@pytest.mark.parametrize("name,kw", [("FastGPLattice", dict(alpha=2)),
                                     ("FastGPDigitalNetB2", dict(alpha=3))])
def test_derivative_informed_matches_dense(name, kw):
    """f, df/dx0 and df/dx1 as three tasks (M = 4): the task Gram pinned to
    all ones and untrained; coefficients atol 1e-5, posterior mean of f
    atol 1e-8."""
    gp, ys = _deriv_model(ft, name, **kw)
    np.testing.assert_allclose(gp.gram_matrix_tasks.numpy(), 1.0)
    assert not gp.params["factor_task_kernel"].trainable
    xq = np.random.default_rng(2).uniform(size=(6, 2))
    _check_dense(gp, ys, 0, xq, 1e-5, 1e-8)


def test_derivative_informed_mll_and_gradient_match_jax():
    """The digital net's derivative-informed MLL, its terms and its gradient
    against the JAX package at rtol 1e-8 (M = 4: one Schur level)."""
    gt, _ = _deriv_model(ft, "FastGPDigitalNetB2", alpha=3)
    gj, _ = _deriv_model(fj, "FastGPDigitalNetB2", alpha=3)
    const = 64 * math.log(2 * math.pi)
    loss_t, terms_t, grads_t = gt._make_loss_fn("MLL", None, 1, const, 1)(
        gt._raw_dict(), gt._fit_data())
    (loss_j, terms_j), grads_j = gj._make_loss_fn("MLL", None, 1, const, 1)(
        gj._raw_dict(), gj._fit_data())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-8)
    np.testing.assert_allclose([float(v) for v in terms_t], [float(v) for v in terms_j],
                               rtol=1e-8)
    for k in ("scale", "lengthscales"):
        np.testing.assert_allclose(grads_t[k].numpy(), np.asarray(grads_j[k]), rtol=1e-8, err_msg=k)


def _grad_informed_dnb2(lib, dtype, n=1 << 12):
    """``bench.py:make_lattice_grad`` on the digital net (d = 3, alpha = 3,
    (f, grad f) as 4 tasks of n points, noise 1e-8), lengthscales drawn from
    a seed: the cross-check configuration of ``chip_smoke.py``'s
    deriv_dnb2.  Returns the model's coefficients and log-determinant in
    float64."""
    d = 3
    derivs = [np.zeros((1, d), dtype=np.int64)] + [e[None, :] for e in np.eye(d, dtype=np.int64)]
    tasks = list(range(d + 1))
    extra = {} if lib is fj else {"device": "cpu"}
    gp = lib.FastGPDigitalNetB2(d, num_tasks=d + 1, seed_for_seq=7, alpha=3, derivatives=derivs,
                                dtype=dtype, **extra)
    if lib is fj:
        xs = [np.asarray(x) for x in gp.get_x_next([n] * (d + 1), tasks)]
    else:
        xs = gp.get_x_next_host([n] * (d + 1), task=tasks)
    ys = [np.sin(2 * np.pi * xs[0][:, 0])] + [
        2 * np.pi * np.cos(2 * np.pi * x[:, 0]) * (j == 0) for j, x in enumerate(xs[1:])]
    wrap = (lambda y: jnp.asarray(y, dtype=dtype)) if lib is fj else torch.from_numpy
    gp.add_y_next([wrap(y) for y in ys], tasks)
    raw = {k: np.asarray(v, dtype=np.float64) for k, v in gp._raw_dict().items()}
    raw["lengthscales"] = np.random.default_rng(7).uniform(-0.5, 0.5, raw["lengthscales"].shape)
    raw["noise"] = np.full(raw["noise"].shape, math.log(1e-8))
    if lib is fj:
        gp._set_raw({k: jnp.asarray(v, dtype=dtype) for k, v in raw.items()})
    else:
        ft.load_jax_params(gp, raw)
    return (np.asarray(gp.coeffs, dtype=np.float64),
            float(np.asarray(gp._solver().factor.logdet, dtype=np.float64)))


def test_grad_informed_dnb2_float32_unresolved_in_both_packages():
    """Float32 does not resolve the derivative-informed digital net at n =
    2^12 (noise 1e-8, the task kernel pinned to all ones): the eigenvalue
    floor and the ridge decide its small eigenvalues, in the JAX package as
    in the port.  The two packages agree in float64 (rtol 1e-8); the JAX
    package's float32 coefficients are more than 0.1 (of the max) off its
    float64 ones, so no float32 run of this model can be held at 5e-5; and
    the port's float32 is no further from float64 than 1.5 times the JAX
    package's is."""
    c64_t, ld64_t = _grad_informed_dnb2(ft, torch.float64)
    c64_j, ld64_j = _grad_informed_dnb2(fj, jnp.float64)
    scale = np.abs(c64_j).max()
    np.testing.assert_allclose(c64_t, c64_j, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(ld64_t, ld64_j, rtol=1e-8)
    c32_t, _ = _grad_informed_dnb2(ft, torch.float32)
    c32_j, _ = _grad_informed_dnb2(fj, jnp.float32)
    gap_j = np.abs(c32_j - c64_j).max() / scale
    gap_t = np.abs(c32_t - c64_t).max() / scale
    assert gap_j > 0.1, gap_j
    assert gap_t < 1.5 * gap_j, (gap_t, gap_j)


@pytest.mark.parametrize("name,kw", [("FastGPLattice", dict(alpha=3)),
                                     ("FastGPDigitalNetB2", dict(alpha=4))])
def test_weighted_multirow_derivatives_match_dense(name, kw):
    """Task 1 observes 2 df/dx0 - 0.5 df/dx1 (two derivative rows with
    weights): coefficients atol 1e-5, its posterior mean atol 1e-7; a short
    fit stays finite."""
    d = 2
    derivs = [np.zeros((1, d), dtype=np.int64), np.array([[1, 0], [0, 1]], dtype=np.int64)]
    coeffs = [np.array([1.0]), np.array([2.0, -0.5])]
    gp = getattr(ft, name)(d, num_tasks=2, seed_for_seq=5, derivatives=derivs,
                           derivatives_coeffs=coeffs, noise=1e-4, device="cpu", **kw)
    xs = gp.get_x_next_host([32, 16], task=[0, 1])
    ys = [f_poly(xs[0]), 2.0 * df_dx0(xs[1]) - 0.5 * df_dx1(xs[1])]
    gp.add_y_next([torch.from_numpy(y) for y in ys], task=[0, 1])
    _check_dense(gp, ys, 1, np.random.default_rng(4).uniform(size=(5, d)), 1e-5, 1e-7)
    data = gp.fit(iterations=5, verbose=0, store_loss_hist=True)
    assert np.isfinite(data["loss_hist"]).all()


def test_adaptive_nugget_matches_dense_and_jax():
    """``adaptive_nugget``: each task's noise scaled by its Gram trace over
    task 0's.  Coefficients and log-determinant against the dense oracle
    (atol 1e-6, rtol 1e-7), and the MLL and its gradient against the JAX
    package at rtol 1e-8."""
    ns = [16, 8]
    kw = dict(num_tasks=2, seed_for_seq=6, noise=1e-2, adaptive_nugget=True,
              factor_task_kernel=np.array([[1.0], [0.3]]))
    gt = ft.FastGPLattice(2, device="cpu", **kw)
    gj = fj.FastGPLattice(2, **kw)
    xs = gt.get_x_next_host(ns, task=[0, 1])
    ys = [np.sin(2 * np.pi * x[:, 0]) + x[:, 1] for x in xs]
    gt.add_y_next([torch.from_numpy(y) for y in ys], task=[0, 1])
    gj.add_y_next([jnp.asarray(y) for y in ys], task=[0, 1])
    K = dense_gram(gt)
    np.testing.assert_allclose(gt.coeffs.numpy(), _solve(K, np.concatenate(ys)), atol=1e-6)
    np.testing.assert_allclose(float(gt._solver().factor.logdet), _logdet(K), rtol=1e-7)
    # the adaptive nugget moves the system: without it the log-determinant differs
    gt.adaptive_nugget = False
    gt._solver_cache.clear()
    assert abs(float(gt._solver().factor.logdet) - _logdet(K)) > 1e-3
    gt.adaptive_nugget = True
    gt._solver_cache.clear()
    const = 24 * math.log(2 * math.pi)
    loss_t, _, grads_t = gt._make_loss_fn("MLL", None, 1, const, 1)(gt._raw_dict(),
                                                                     gt._fit_data())
    (loss_j, _), grads_j = gj._make_loss_fn("MLL", None, 1, const, 1)(gj._raw_dict(),
                                                                      gj._fit_data())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-8)
    for k in ("scale", "lengthscales", "factor_task_kernel", "noise_task_kernel"):
        want = np.asarray(grads_j[k])
        np.testing.assert_allclose(grads_t[k].numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(), err_msg=k)


def _fleet_pair(shape_batch, n=64, **kw):
    """A lattice fleet of the port and of the JAX package on the same points,
    member (i, j, ...) observing ``f_poly * (1 + flat index)``."""
    gt = ft.FastGPLattice(2, seed_for_seq=3, shape_batch=shape_batch, device="cpu", **kw)
    gj = fj.FastGPLattice(2, seed_for_seq=3, shape_batch=shape_batch, **kw)
    x = gt.get_x_next_host(n)
    B = int(np.prod(shape_batch))
    ys = np.stack([f_poly(x) * (b + 1) for b in range(B)]).reshape(shape_batch + (n,))
    gt.add_y_next(torch.from_numpy(ys))
    gj.add_y_next(jnp.asarray(ys))
    return gt, gj


def test_fleet_and_masks_match_jax():
    """A (2, 3) fleet with full-batch lengthscales and per-column scales:
    coefficients, posterior mean and variance, a full-fleet MLL fit, then a
    masked one (members (0, 0) and (1, 2)), their loss histories and the
    fitted parameters at rtol 1e-8; the masked fit moves only the masked
    members' lengthscales."""
    sb = (2, 3)
    gt, gj = _fleet_pair(sb, shape_lengthscales=sb + (2,), shape_scale=(3, 1))
    close = dict(rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gt.coeffs.numpy(), np.asarray(gj.coeffs), **close)
    xq = np.random.default_rng(1).uniform(size=(5, 2))
    for a, b in zip(gt.post_mean_var(xq), gj.post_mean_var(xq)):
        assert a.shape == sb + (5,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
    for masks in (None, np.array([[0, 0], [1, 2]]).T):
        before = gt.lengthscales.numpy().copy()
        dt = gt.fit(iterations=6, verbose=0, masks=masks, store_loss_hist=True)
        dj = gj.fit(iterations=6, verbose=0, masks=masks, store_loss_hist=True)
        np.testing.assert_allclose(dt["loss_hist"], np.asarray(dj["loss_hist"]), rtol=1e-8)
        for k in ("scale", "lengthscales"):
            np.testing.assert_allclose(gt.params[k].raw.numpy(), np.asarray(gj.params[k].raw),
                                       rtol=1e-8, atol=1e-12, err_msg=k)
    moved = ~np.isclose(gt.lengthscales.numpy(), before).all(-1)
    np.testing.assert_array_equal(moved, [[True, False, False], [False, False, True]])
    assert gt.post_cubature_mean().shape == sb and gt.post_cubature_var().shape == sb


@pytest.mark.parametrize("metric", ["GCV", "CV"])
def test_fleet_masked_gcv_cv_match_jax(metric):
    """Masked GCV and CV on a 3-member fleet (a boolean mask over members
    0 and 2): loss histories at rtol 1e-8, member 1 untouched."""
    gt, gj = _fleet_pair((3,), shape_lengthscales=(3, 2), shape_scale=(3, 1), noise=1e-4)
    masks = np.array([[True, False, True]])
    before = gt.lengthscales.numpy().copy()
    dt = gt.fit(loss_metric=metric, iterations=5, verbose=0, masks=masks, store_loss_hist=True)
    dj = gj.fit(loss_metric=metric, iterations=5, verbose=0, masks=masks, store_loss_hist=True)
    np.testing.assert_allclose(dt["loss_hist"], np.asarray(dj["loss_hist"]), rtol=1e-8)
    np.testing.assert_array_equal(gt.lengthscales.numpy()[1], before[1])


def test_digital_fleet_member_equals_single_model():
    """Member b of a digital-net fleet serves what a single model with
    member b's hyperparameters and data serves (rtol 1e-10)."""
    B, n = 3, 128
    ls = np.array([[0.5, 1.0], [1.0, 2.0], [2.0, 0.7]])
    fleet = ft.FastGPDigitalNetB2(2, seed_for_seq=3, shape_batch=(B,), lengthscales=ls,
                                  scale=np.array([[1.0], [2.0], [0.5]]), noise=1e-6,
                                  device="cpu")
    x = fleet.get_x_next_host(n)
    ys = np.stack([f_poly(x) * (b + 1) for b in range(B)])
    fleet.add_y_next(torch.from_numpy(ys))
    xq = np.random.default_rng(1).uniform(size=(7, 2))
    pm, pv = fleet.post_mean_var(xq)
    assert pm.shape == pv.shape == (B, 7)
    for b in range(B):
        one = ft.FastGPDigitalNetB2(2, seed_for_seq=3, lengthscales=ls[b], noise=1e-6,
                                    scale=[1.0, 2.0, 0.5][b], device="cpu")
        one.get_x_next_host(n)
        one.add_y_next(torch.from_numpy(ys[b]))
        pm1, pv1 = one.post_mean_var(xq)
        np.testing.assert_allclose(pm[b].numpy(), pm1.numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(pv[b].numpy(), pv1.numpy(), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(float(fleet.post_cubature_var()[b]),
                                   float(one.post_cubature_var()), rtol=1e-10)


def test_float32_perm_fleet_runs_k3_per_member(monkeypatch):
    """A float32 lattice fleet on the permuted path (forced on the CPU, the
    plain kernel versions): its posterior variance (K3 once per member, each
    with its own weights) equals each member's own model's within 4 float32
    ulps of the prior, and its mean within 2e-4 of the max (the bound of
    ``test_torch_lattice_gp``'s well-conditioned float32 case: the plain
    versions' matmuls round differently for two rows than for one)."""
    monkeypatch.setenv("FASTGPS_TORCH_FORCE_PERM", "1")
    B, n = 2, 1 << 14
    ls = np.array([[0.7, 1.3], [1.5, 0.9]])
    kw = dict(seed_for_seq=11, dtype=torch.float32, noise=1.0, device="cpu")
    fleet = ft.FastGPLattice(2, shape_batch=(B,), lengthscales=ls, **kw)
    x = fleet.get_x_next_host(n)
    ys = np.stack([(f_poly(x) + x.sum(1)) * (b + 1) for b in range(B)]).astype(np.float32)
    fleet.add_y_next(torch.from_numpy(ys))
    assert type(fleet._solver()).__name__ == "_PermSpectrumSolver"
    calls = []
    quad = tp.pfft_quad
    monkeypatch.setattr(tp, "pfft_quad", lambda *a: calls.append(a[0].shape) or quad(*a))
    xq = np.random.default_rng(2).uniform(size=(9, 2))
    pm, pv = fleet.post_mean_var(xq)
    assert calls == [(1, 9, n)] * B
    eps32 = float(np.finfo(np.float32).eps)
    for b in range(B):
        one = ft.FastGPLattice(2, lengthscales=ls[b], **kw)
        one.get_x_next_host(n)
        one.add_y_next(torch.from_numpy(ys[b]))
        pm1, pv1 = one.post_mean_var(xq)
        assert float((pv[b] - pv1).abs().max()) < 4 * eps32 * float(one.scale[0])
        assert float((pm[b] - pm1).abs().max()) < 2e-4 * float(pm1.abs().max())


@pytest.mark.parametrize("R,cap", [(1, 1), (7, 3), (9, 3), (70000, 65535)])
def test_row_blocks_cover_rows_once(R, cap):
    blocks = tp.row_blocks(R, cap)
    assert blocks[0][0] == 0 and blocks[-1][1] == R
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert all(0 < r1 - r0 <= cap for r0, r1 in blocks)


def test_kernel_emulations_by_row_blocks_match_whole():
    """K1-K3's algorithms (the emulations) run block by block over 7 rows at
    a cap of 3, as the wrappers launch them, equal the whole-batch run: K1
    and K2 bit for bit, K3 within float32 rounding (rtol 2e-6: its
    emulation's batched matmuls round differently for fewer rows; the card
    test below holds the kernels bit for bit)."""
    n, R = 1 << 14, 7
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, n, generator=g) + 1.0
    X = torch.complex(torch.randn(R, n, generator=g), torch.randn(R, n, generator=g))
    A0, Bh, Bl, _ = tp._plan(n)
    wk = torch.rand(Bh, A0, Bl, generator=g)
    mean = x.mean(-1)
    ops = [(lambda v: tp.pfft_emulate(v, n), x), (lambda v: tp.pifft_real_emulate(v, n), X)]
    for fn, v in ops:
        whole = fn(v)
        assert torch.equal(torch.cat([fn(v[r0:r1]) for r0, r1 in tp.row_blocks(R, 3)]), whole)
    whole = tp.quad_emulate(x, wk, n, mean)
    tiled = torch.cat([tp.quad_emulate(x[r0:r1], wk, n, mean[r0:r1])
                       for r0, r1 in tp.row_blocks(R, 3)])
    torch.testing.assert_close(tiled, whole, rtol=2e-6, atol=0)


@pytest.mark.cuda
def test_card_kernels_by_row_blocks_match_one_launch(monkeypatch):
    """On the card, K1-K3 with the row cap lowered to 3 (13 rows: 5 launches
    each) equal their one-launch results bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    n, R = 1 << 15, 13
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(R, n, generator=g) + 1.0).cuda()
    A0, Bh, Bl, _ = tp._plan(n)
    wk = torch.rand(Bh, A0, Bl, generator=g).cuda()
    mean = x.mean(-1)
    one = (tp.pfft(x, n), tp.quad_partials(x, wk, n, mean))
    one = one + (tp.pifft_real(one[0], n),)
    monkeypatch.setattr(tp, "MAX_GRID_ROWS", 3)
    tp.reset_launches()
    tiled = (tp.pfft(x, n), tp.quad_partials(x, wk, n, mean))
    tiled = tiled + (tp.pifft_real(one[0], n),)
    assert tp.launches == {"pfft": 5, "pifft_real": 5, "pifft": 0, "quad": 5}
    for a, b in zip(one, tiled):
        assert torch.equal(a, b)


def test_load_jax_params_carries_fleet_and_task_shapes():
    """A 2-member fleet of a 3-task model with a rank-2 task factor of shape
    (2, 3, 2) and per-member noise: ``load_jax_params`` carries every raw
    parameter over, and the task Grams agree (rtol 1e-12)."""
    rng = np.random.default_rng(0)
    kw = dict(num_tasks=3, seed_for_seq=1, shape_batch=(2,), adaptive_nugget=True,
              factor_task_kernel=rng.uniform(0.5, 1.5, (2, 3, 2)),
              noise_task_kernel=rng.uniform(0.1, 0.5, (2, 3)), noise=np.array([[1e-3], [1e-2]]))
    gj = fj.FastGPDigitalNetB2(2, **kw)
    gt = ft.FastGPDigitalNetB2(2, device="cpu", **kw)
    raw = {k: np.asarray(v) * 1.1 for k, v in gj._raw_dict().items()}
    gj._set_raw({k: jnp.asarray(v) for k, v in raw.items()})
    ft.load_jax_params(gt, raw, {k: p.trainable for k, p in gj.params.items()})
    for k, v in raw.items():
        np.testing.assert_array_equal(gt.params[k].raw.numpy(), v)
    assert gt.adaptive_nugget
    np.testing.assert_allclose(gt.gram_matrix_tasks.numpy(), np.asarray(gj.gram_matrix_tasks),
                               rtol=1e-12)
