"""Kernel K5 (ops/si_cross: the lattice's Bernoulli series cross-kernel):
its plain version against ``kernel_fused_scan``'s loop and the JAX
package's ``kernel_fused_scan``, the batching and task factor of the
dispatch, and, on the card, the kernel against the plain version.

Tolerances are relative to the largest kernel value: the plain version and
the kernel fold the lengthscale and the indicator into the Horner
coefficients and evaluate at ``|x - z|``, so they round otherwise than the
loop, and where a factor ``ind + ls coeff B_m`` passes through zero the
elementwise relative gap has no bound.  float64: ``RTOL`` = 1e-12, as
tests/test_torch_series.py holds the loop against the JAX package; float32
against the float64 loop: 1e-5, float32 rounding over up to 13 factors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fastgaussianprocesses_torch as ft  # noqa: E402
from fastgaussianprocesses_torch.kernels import series as ts  # noqa: E402
from fastgaussianprocesses_torch.ops import si_cross as sc  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-12
TOL32 = 1e-5
M = 517               # columns: not a multiple of the kernel's 512-column tile
B = 2                 # hyperparameter rows

# (alpha, beta0, beta1, c0, c1): mixed per-dimension smoothness 1-4, and the
# derivative pairs of tests/test_torch_series.py (both indicator values, odd
# and even orders)
CASES = {
    "d1": (np.array([3]), np.zeros((1, 1), int), np.zeros((1, 1), int), [1.0], [1.0]),
    "d8": (np.full(8, 2), np.zeros((1, 8), int), np.zeros((1, 8), int), [1.0], [1.0]),
    "d13": (np.array([1, 2, 3, 4, 2, 1, 3, 2, 4, 1, 2, 3, 1]), np.zeros((1, 13), int),
            np.zeros((1, 13), int), [1.0], [1.0]),
    "pairs": (np.array([2, 1, 3, 2]), np.array([[0, 0, 0, 0], [1, 0, 0, 0]]),
              np.array([[0, 0, 0, 0], [0, 0, 1, 0]]), [1.0, 0.5], [1.0, -2.0]),
}


def _data(d, iso, seed=0):
    rng = np.random.default_rng(seed)
    x, z = rng.random((5, d)), rng.random((M, d))
    scale = rng.uniform(0.5, 2.0, (B, 1))
    ls = rng.uniform(0.3, 2.0, (B, 1 if iso else d))
    return x, z, scale, ls


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype)


def _loop(x, z, case, scale, ls, dtype=torch.float64, bernoulli=False, factor=None):
    alpha, beta0, beta1, c0, c1 = case
    part = lambda dl, j, b, k: ts.si_part_dim(dl, int(alpha[j]), b, k)
    return ts.kernel_fused_scan(part, x, z, ts.lattice_ominus, beta0, beta1, c0, c1,
                                scale, ls, alpha, bernoulli=bernoulli, factor=factor)


def _gap(got, want):
    got, want = (torch.as_tensor(np.array(v, dtype=np.float64)) if not torch.is_tensor(v)
                 else v.double() for v in (got, want))
    assert tuple(got.shape) == tuple(want.shape)
    return float((got - want).abs().max() / want.abs().max())


def _plain(x, z, case, scale, ls, dtype, paired=False):
    """The wrapper on CPU tensors (its plain version), one row a batch row."""
    alpha, beta0, beta1, c0, c1 = case
    d = x.shape[-1]
    lsb = _t(np.broadcast_to(ls, (B, d)), dtype)
    return sc.si_cross(_t(x, dtype), _t(z[:len(x)] if paired else z, dtype), alpha, beta0,
                       beta1, c0, c1, _t(scale[:, 0], dtype), lsb, paired=paired)


@pytest.mark.parametrize("iso", [False, True], ids=["aniso", "iso"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_loop_and_jax_float64(name, iso):
    """Outer (5, M) and paired (5,) layouts, a batch of two hyperparameter
    rows: the plain version against the loop and the JAX package's
    ``kernel_fused_scan``, RTOL of the largest value."""
    import jax.numpy as jnp
    from fastgaussianprocesses_tpu.kernels import series as js

    case = CASES[name]
    alpha, beta0, beta1, c0, c1 = case
    x, z, scale, ls = _data(len(alpha), iso)
    part_j = lambda dl, j, b, k: js.si_part_dim(dl, int(alpha[j]), b, k)
    for paired in (False, True):
        got = _plain(x, z, case, scale, ls, torch.float64, paired)
        xa, za = (x, z[:5]) if paired else (x[:, None, :], z[None, :, :])
        for b in range(B):
            loop = _loop(_t(xa), _t(za), case, _t(scale[b]), _t(ls[b]))
            jax = js.kernel_fused_scan(part_j, jnp.asarray(xa), jnp.asarray(za),
                                       js.lattice_ominus, beta0, beta1, c0, c1,
                                       jnp.asarray(scale[b]), jnp.asarray(ls[b]), alpha)
            assert _gap(got[b], loop) < RTOL
            assert _gap(got[b], np.asarray(jax)) < RTOL


@pytest.mark.parametrize("name", list(CASES))
def test_plain_float32_within_rounding(name):
    """The plain version in float32 against the float64 loop."""
    case = CASES[name]
    x, z, scale, ls = _data(len(case[0]), iso=False, seed=1)
    for paired in (False, True):
        got = _plain(x, z, case, scale, ls, torch.float32, paired)
        assert got.dtype == torch.float32
        xa, za = (x, z[:5]) if paired else (x[:, None, :], z[None, :, :])
        for b in range(B):
            assert _gap(got[b], _loop(_t(xa), _t(za), case, _t(scale[b]), _t(ls[b]))) < TOL32


@pytest.mark.parametrize("iso", [False, True], ids=["aniso", "iso"])
def test_dispatch_batch_and_factor_match_loop(iso):
    """``kernel_fused_scan``'s K5 route (``_k5``, which on CPU tensors runs
    the plain version): batched scales and lengthscales and a batched task
    factor, as ``_cross_kmat`` and ``_prior_diag`` pass them, give the
    loop's shapes and values; the loop multiplies the factor in afterwards,
    K5 into its scalar."""
    case = CASES["pairs"]
    alpha, beta0, beta1, c0, c1 = case
    x, z, scale, ls = _data(len(alpha), iso, seed=2)
    factor = _t(np.array([0.7, 1.9]))[:, None, None]
    xa, za = _t(x[:, None, :]), _t(z[None, :, :])
    want = _loop(xa, za, case, _t(scale), _t(ls), factor=factor)
    got = ts._k5(xa, za, beta0, beta1, c0, c1, _t(scale), _t(ls), alpha, factor)
    assert tuple(got.shape) == (B, 5, M)
    assert _gap(got, want) < RTOL
    for f in (None, factor[..., 0]):
        got = ts._k5(_t(x), _t(z[:5]), beta0, beta1, c0, c1, _t(scale), _t(ls), alpha, f)
        want = _loop(_t(x), _t(z[:5]), case, _t(scale), _t(ls), factor=f)
        assert tuple(got.shape) == tuple(want.shape) == (B, 5)
        assert _gap(got, want) < RTOL


def test_cpu_tensors_keep_the_loop():
    """On CPU tensors ``bernoulli=True`` changes nothing (the loop, bit for
    bit), and a CPU lattice's queries launch no kernel."""
    case = CASES["pairs"]
    x, z, scale, ls = _data(4, iso=False, seed=3)
    sc.reset_launches()
    xa, za = _t(x[:, None, :]), _t(z[None, :, :])
    for bern in (False, True):
        assert torch.equal(_loop(xa, za, case, _t(scale), _t(ls), bernoulli=bern),
                           _loop(xa, za, case, _t(scale), _t(ls)))
    gp = ft.FastGPLattice(3, seed_for_seq=5, alpha=2, device="cpu")
    xs = gp.get_x_next(64)
    gp.add_y_next(torch.sin(2 * torch.pi * xs[:, 0]) + xs.sum(1))
    pm, pv = gp.post_mean_var(torch.rand(6, 3, dtype=torch.float64))
    assert pm.shape == pv.shape == (6,)
    assert sc.launches == {"si_cross": 0, "si_pair": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    case = CASES["d8"]
    alpha, beta0, beta1, c0, c1 = case
    x, z, scale, ls = (_t(v) for v in _data(8, iso=False))
    s = scale[:, 0]
    with pytest.raises(ValueError):
        sc.si_cross(x.float(), z, alpha, beta0, beta1, c0, c1, s, ls)
    with pytest.raises(ValueError):
        sc.si_cross(x, z, alpha, beta0, beta1, c0, c1, s, ls[:, :4])
    with pytest.raises(ValueError):
        sc.si_cross(x, z[:7], alpha, beta0, beta1, c0, c1, s, ls, paired=True)
    with pytest.raises(ValueError):
        sc.si_cross(x.long(), z.long(), alpha, beta0, beta1, c0, c1, s.long(), ls.long())
    with pytest.raises(ValueError):
        sc.si_cross(x, z, alpha, beta0, beta1, c0, c1, s, ls, s[:1])
    with pytest.raises(NotImplementedError):
        sc.si_cross(x, z, alpha, beta0, beta1, c0, c1, s, ls.requires_grad_())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_card_kernel_matches_plain(dtype):
    """K5 against the plain version on the same card tensors: every case
    above (the derivative pairs with task factors), outer and paired, the
    query chunk's 59 rows against 2^16 + 4 columns and a tail tile of 3
    rows; float64 to RTOL, float32 to TOL32 (the kernel's fused
    multiply-adds round otherwise than torch's ops)."""
    dev = _card()
    tol = RTOL if dtype == torch.float64 else TOL32
    for name, (R, Mc) in [("d1", (5, M)), ("d8", (59, (1 << 16) + 4)), ("d8", (3, M)),
                          ("d13", (13, M)), ("pairs", (11, 1000))]:
        alpha, beta0, beta1, c0, c1 = CASES[name]
        d = len(alpha)
        rng = np.random.default_rng(7)
        x = _t(rng.random((R, d)), dtype).to(dev)
        z = _t(rng.random((Mc, d)), dtype).to(dev)
        s = _t(rng.uniform(0.5, 2.0, B), dtype).to(dev)
        ls = _t(rng.uniform(0.3, 2.0, (B, d)), dtype).to(dev)
        f = _t(rng.uniform(0.5, 2.0, B), dtype).to(dev) if name == "pairs" else None
        tb = sc.table(alpha, beta0, beta1, c0, c1, dtype, dev)
        sc.reset_launches()
        for paired, zz in ((False, z), (True, z[:R].contiguous())):
            got = sc.si_cross(x, zz, alpha, beta0, beta1, c0, c1, s, ls, f, paired=paired)
            torch.cuda.synchronize()
            want = sc.si_cross_plain(x, zz, tb, s, ls, f, paired)
            assert got.dtype == dtype and not got.isnan().any()
            assert _gap(got.cpu(), want.cpu()) < tol, (name, R, Mc, paired)
        assert sc.launches == {"si_cross": 1, "si_pair": 1}


@pytest.mark.cuda
def test_card_post_mean_var_launches_k5_a_chunk(monkeypatch):
    """A float32 lattice at n = 2^16 served on the card: one K5 launch a
    query chunk for the cross-kernel and one for the prior diagonal, the
    loop never reached, and the mean and variance those of the same model
    on the CPU (its loop) to float32's rounding, relative to the largest
    (chip_smoke.py's phase 4 allows 5e-5 between the two paths)."""
    dev = _card()
    N, n = 2000, 1 << 16
    xq = np.random.default_rng(5).uniform(size=(N, 8))

    def served(device):
        gp = ft.FastGPLattice(8, seed_for_seq=7, alpha=2, dtype=torch.float32, device=device)
        x = gp.get_x_next_host(n)
        gp.add_y_next(torch.from_numpy((np.sin(2 * np.pi * x[:, 0]) + x.sum(1))
                                       .astype(np.float32)))
        return gp, [v.cpu().double() for v in gp.post_mean_var(xq)]

    _, (pm_cpu, pv_cpu) = served("cpu")

    def refuse(*a, **k):
        raise AssertionError("the card path reached the loop")

    monkeypatch.setattr(ts, "si_part_dim", refuse)
    sc.reset_launches()
    gp, (pm, pv) = served(dev)
    chunks = -(-N // gp._query_chunk_size(N, n))
    assert chunks > 1
    assert sc.launches == {"si_cross": chunks, "si_pair": chunks}
    # K5's arithmetic run on the CPU in the loop's place read 6.4e-6 and 2.0e-5 here
    assert _gap(pm, pm_cpu) < 5e-5
    assert _gap(pv, pv_cpu) < 1e-4
