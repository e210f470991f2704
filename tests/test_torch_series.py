"""Port parity for the shift-invariant series kernels (kernels/series.py) in
float64 against the JAX package, rtol 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fastgaussianprocesses_torch.kernels import series as ts  # noqa: E402
from fastgaussianprocesses_tpu.kernels import series as js  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-12
# mixed smoothness and derivative orders: exercises the grouping by series
# signature and both indicator values
ALPHA = np.array([2, 1, 3, 2])
BETA0 = np.array([[0, 0, 0, 0], [1, 0, 0, 0]])
BETA1 = np.array([[0, 0, 0, 0], [0, 0, 1, 0]])
C0 = np.array([1.0, 0.5])
C1 = np.array([1.0, -2.0])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))


def _data():
    rng = np.random.default_rng(3)
    x = rng.random((5, 4))
    z = rng.random((64, 4))
    scale = np.array([1.7])
    ls = np.array([0.6, 1.3, 0.9, 2.1])
    return x, z, scale, ls


def test_si_parts_from_delta_matches_jax():
    delta = np.random.default_rng(0).random((33, 4))
    for beta, kappa in [(BETA0[0], BETA1[0]), (BETA0[1], BETA1[1])]:
        got = ts.si_parts_from_delta(_t(delta), ALPHA, beta, kappa).numpy()
        want = np.asarray(js.si_parts_from_delta(jnp.asarray(delta), ALPHA, beta, kappa))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_kernel_from_parts_t_forward_matches_jax():
    x, z, scale, ls = _data()
    parts_fn_t = lambda dl, b, k: ts.si_parts_from_delta(dl, ALPHA, b, k)
    parts_fn_j = lambda dl, b, k: js.si_parts_from_delta(dl, ALPHA, b, k)
    pt = ts.kernel_parts(parts_fn_t, _t(z), _t(x[:1]), ts.lattice_ominus, BETA0, BETA1)
    pj = js.kernel_parts(parts_fn_j, jnp.asarray(z), jnp.asarray(x[:1]), js.lattice_ominus,
                         BETA0, BETA1)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL, atol=0)
    pt_t = torch.movedim(pt, 0, -1).contiguous()                     # (p0, p1, d, n)
    pj_t = jnp.moveaxis(pj, 0, -1)
    for ls_v in (ls, ls[:1]):                                        # anisotropic, isotropic
        got = ts.kernel_from_parts_t(pt_t, BETA0, BETA1, C0, C1, _t(scale), _t(ls_v))
        want = js.kernel_from_parts_t(pj_t, BETA0, BETA1, C0, C1, jnp.asarray(scale),
                                      jnp.asarray(ls_v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)


def test_kernel_fused_scan_matches_jax():
    x, z, scale, ls = _data()
    part_t = lambda dl, j, b, k: ts.si_part_dim(dl, int(ALPHA[j]), b, k)
    part_j = lambda dl, j, b, k: js.si_part_dim(dl, int(ALPHA[j]), b, k)
    # cross (N, n) and diagonal (N,) layouts, as the posterior queries use them
    for xa, za in ((x[:, None, :], z[None, :, :]), (x, x)):
        got = ts.kernel_fused_scan(part_t, _t(xa), _t(za), ts.lattice_ominus, BETA0, BETA1,
                                   C0, C1, _t(scale), _t(ls), ALPHA)
        want = js.kernel_fused_scan(part_j, jnp.asarray(xa), jnp.asarray(za),
                                    js.lattice_ominus, BETA0, BETA1, C0, C1,
                                    jnp.asarray(scale), jnp.asarray(ls), ALPHA)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
