"""Port parity for the slice as a whole: posterior serving on FastGPLattice.

* float64, half-spectrum path: the pinned golden and the JAX doctest's
  posterior with hyperparameters carried over by ``load_jax_params``;
* float32, permuted-spectrum path (kernels K1-K3 as plain versions on the
  CPU; the JAX package's Pallas kernels in interpret mode), forced on both
  sides at n = 2^14;
* the port imports neither JAX nor the JAX package.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.models.fast import (_HalfSpectrumSolver,  # noqa: E402
                                                     _PermSpectrumSolver)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)


def _f_golden(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[:, 0]) + np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _f_doc(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def test_golden_cubature_f64():
    """tests/test_goldens.py's lattice cm0/cv0 (seed 42, n = 64)."""
    gp = ft.FastGPLattice(2, seed_for_seq=42, device="cpu")
    x = gp.get_x_next(64)
    gp.add_y_next(torch.from_numpy(_f_golden(x.numpy())))
    assert isinstance(gp._solver(), _HalfSpectrumSolver)
    np.testing.assert_allclose(float(gp.post_cubature_mean()), 0.9993663022330068, rtol=1e-8)
    np.testing.assert_allclose(float(gp.post_cubature_var()), 0.00023961740387090646,
                               rtol=1e-8)


def test_doctest_posterior_with_jax_hyperparameters_f64():
    """The lattice_gp.py doctest setup: JAX fits, the port serves with the
    carried-over hyperparameters; both posteriors agree at rtol 1e-8."""
    gj = fj.FastGPLattice(2, seed_for_seq=7, alpha=2)
    xj = np.asarray(gj.get_x_next(64))
    gj.add_y_next(jnp.asarray(_f_doc(xj)))
    gj.fit(iterations=40, verbose=0)
    gt = ft.FastGPLattice(2, seed_for_seq=7, alpha=2, device="cpu")
    assert np.array_equal(gt.get_x_next(64).numpy(), xj)
    gt.add_y_next(torch.from_numpy(_f_doc(xj)))
    ft.load_jax_params(gt, {k: np.asarray(v) for k, v in gj._raw_dict().items()})
    xq = np.array([[0.1, 0.2], [0.5, 0.5], [0.9, 0.8]])
    pm_t, pv_t = gt.post_mean_var(xq)
    pm_j, pv_j = gj.post_mean_var(xq)
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=1e-8)
    np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j), rtol=1e-8)
    np.testing.assert_allclose([round(float(v), 4) for v in pm_t], [0.416, 0.9556, 1.4521])
    np.testing.assert_allclose(gt.post_mean(xq).numpy(), np.asarray(gj.post_mean(xq)),
                               rtol=1e-8)
    np.testing.assert_allclose(gt.post_var(xq).numpy(), pv_t.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(gt.post_cubature_mean()),
                               float(gj.post_cubature_mean()), rtol=1e-8)
    np.testing.assert_allclose(float(gt.post_cubature_var()),
                               float(gj.post_cubature_var()), rtol=1e-8)
    # future-n variance projection (the points beyond n = 64 are drawn too)
    np.testing.assert_allclose(gt.post_var(xq, n=128).numpy(),
                               np.asarray(gj.post_var(xq, n=128)), rtol=1e-8)
    _, pv128 = gt.post_mean_var(xq, n=128)
    np.testing.assert_allclose(pv128.numpy(), np.asarray(gj.post_var(xq, n=128)), rtol=1e-8)


def _perm_pair(monkeypatch, noise):
    monkeypatch.setenv("FASTGPS_TPU_FORCE_PERM", "1")
    monkeypatch.setenv("FASTGPS_TORCH_FORCE_PERM", "1")
    n = 1 << 14
    gj = fj.FastGPLattice(2, seed_for_seq=11, dtype=jnp.float32, noise=noise)
    gt = ft.FastGPLattice(2, seed_for_seq=11, dtype=torch.float32, noise=noise, device="cpu")
    x = np.asarray(gj.get_x_next(n))
    assert np.array_equal(gt.get_x_next(n).numpy(), x)
    y = _f_doc(x).astype(np.float32)
    gj.add_y_next(jnp.asarray(y))
    gt.add_y_next(torch.from_numpy(y))
    return gj, gt, n


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("noise", [1e-8, 1.0])
def test_perm_path_matches_jax_f32(monkeypatch, noise):
    """Solver state bin for bin, then the served posterior.

    At noise 1e-8 the f32 solve is ill-conditioned: the JAX package's own
    perm-vs-half comparison (tests/test_pallas_fft.py) allows 4e-3 on the
    mean and 2e-2 on the variance, relative to the max, and the same bounds
    hold here.  Its 2e-3 on coeffs is not kept: the smallest eigenvalues sit
    at the floor 8*eps*max|lam| (~1.6e-2 at n = 2^14) and carry a few ulps of
    max|lam| of error each (lam measured 3.4 ulps apart), so the coefficient
    bins they scale differ by tens of percent; the max difference measured
    2.0e-3 at this size, and the bound is 5e-3.  Noise 1e-2 is barely better (eigenvalues up to ~n
    against 1e-2: coeffs measured 1.3e-3 apart), so the well-conditioned
    case uses noise 1.0, as the JAX package's logic-fault test does, with
    bounds 20x tighter: it catches bin-order, conjugation and scaling faults.
    The cubature variance is scale minus an O(scale) correction, so in f32 it
    is resolved only to a few ulps of scale at either noise.
    """
    gj, gt, n = _perm_pair(monkeypatch, noise)
    sj, st = gj._solver(), gt._solver()
    assert isinstance(st, _PermSpectrumSolver)
    # two f32 evaluations of one factorization: a few ulps of the max
    assert _max_rel(st.lam.numpy(), np.asarray(sj.lam)) < 8 * EPS32
    yt_j = np.asarray(gj._get_ytilde_perm(0, n))
    assert _max_rel(gt._get_ytilde_perm(0, n).numpy(), yt_j) < 8 * EPS32
    loose = 1.0 if noise < 1e-4 else 0.05
    xq = np.random.default_rng(5).uniform(size=(16, 2))
    pm_t, pv_t = gt.post_mean_var(xq)
    pm_j, pv_j = gj.post_mean_var(xq)
    assert _max_rel(gt.coeffs.numpy(), np.asarray(gj.coeffs)) < 5e-3 * loose
    assert _max_rel(pm_t.numpy(), pm_j) < 4e-3 * loose
    assert _max_rel(pv_t.numpy(), pv_j) < 2e-2 * loose
    np.testing.assert_allclose(float(gt.post_cubature_mean()), float(gj.post_cubature_mean()),
                               rtol=1e-4 * loose)
    cv_t, cv_j = float(gt.post_cubature_var()), float(gj.post_cubature_var())
    assert abs(cv_t - cv_j) < 4 * EPS32 * float(gt.scale[0])


def test_no_silent_cpu_fallback_and_unported_solver_raises(monkeypatch):
    """Without a card, the default device raises instead of moving to the
    CPU.  A model with two tasks (once refused here) takes the multitask
    solver: its posterior mean agrees with the dense oracle (atol 1e-8)."""
    from fastgaussianprocesses_torch.utils.debug import dense_gram
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.FastGPLattice(2, seed_for_seq=1)
    gp = ft.FastGPLattice(2, num_tasks=2, seed_for_seq=1, noise=1e-4, device="cpu")
    xs = gp.get_x_next_host([8, 4])
    ys = [_f_doc(x) for x in xs]
    gp.add_y_next([torch.from_numpy(y) for y in ys])
    xq = np.random.default_rng(1).uniform(size=(3, 2))
    S = gp.gram_matrix_tasks.numpy()
    kx = np.concatenate([S[0, l] * gp.kernel(torch.from_numpy(xq)[:, None, :],
                                             gp.get_xb(l)[None, :, :]).numpy() for l in range(2)], -1)
    K = torch.from_numpy(dense_gram(gp))
    want = kx @ torch.linalg.solve(K, torch.from_numpy(np.concatenate(ys))).numpy()
    np.testing.assert_allclose(gp.post_mean(xq, task=0).numpy(), want, atol=1e-8)


def test_debug_flag_refuses_to_build_a_model(monkeypatch):
    """The dense debug oracle is ported: with the flag set a model builds,
    takes the general solver and checks each solver it caches against the
    dense oracle (``utils/debug.check_fast_solver``)."""
    from fastgaussianprocesses_torch.models.fast import _FastSolver
    from fastgaussianprocesses_torch.utils import debug
    monkeypatch.setenv("FASTGPS_TORCH_DEBUG", "1")
    checked = []
    check = debug.check_fast_solver
    monkeypatch.setattr(debug, "check_fast_solver", lambda m, s: checked.append(s) or check(m, s))
    gp = ft.FastGPLattice(2, seed_for_seq=1, noise=1e-4, device="cpu")
    gp.add_y_next(torch.from_numpy(_f_doc(gp.get_x_next_host(16))))
    gp.post_cubature_var()
    assert len(checked) == 1 and isinstance(checked[0], _FastSolver)
    monkeypatch.setenv("FASTGPS_TORCH_DEBUG", "0")
    assert isinstance(gp._solver(n=32), _HalfSpectrumSolver)
    assert len(checked) == 1


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "fastgaussianprocesses_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "fastgaussianprocesses_tpu"), (
                f"{path.relative_to(ROOT)} imports {mod}")
