"""Port parity for the fit step's backward passes, held against the JAX
package's VJPs:

* ``perm_fft.pfft`` (real and complex rows), ``perm_fft.pifft_real`` and
  ``perm_fft.pifft``, each backward the other kernel, against ``jax.vjp``
  of the JAX ``pfft`` / ``pifft`` (Pallas kernels in interpret mode) and
  against ``torch.autograd`` through ``torch.fft`` plus the
  ``spectrum_perm`` gather, at 3e-6 of the max; ``pifft`` itself (the plain
  version and the kernel's algorithm) and ``transforms.pifft_ortho``
  against the JAX package's;
* ``fwht(x, mean)`` against ``jax.vjp`` of the JAX ``fwht`` in float64;
* the stabilized transforms against float64 references;
* ``kernel_from_parts_t``'s value and lengthscale gradient against the JAX
  package's (its ``_prod_terms_t`` custom VJP at d = 8, ``jnp.prod`` above
  ``_PROD_VJP_MAX_D``) in float64;
* the float32 permuted-spectrum MLL and its gradient signs at n = 2^14;
* on the card: each backward launches its kernel and never a plain version.

PyTorch's complex gradient is ``dL/dRe + i dL/dIm``, the conjugate of
JAX's cotangent, so a cotangent ``g`` here is ``conj(g)`` there and the
gradients come back conjugated.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.kernels import series as ts  # noqa: E402
from fastgaussianprocesses_torch.models.fast import _PermSpectrumSolver  # noqa: E402
from fastgaussianprocesses_torch.ops import fwht as tf  # noqa: E402
from fastgaussianprocesses_torch.ops import perm_fft as tp  # noqa: E402
from fastgaussianprocesses_torch.ops import transforms as ttr  # noqa: E402
from fastgaussianprocesses_tpu.kernels import series as js  # noqa: E402
from fastgaussianprocesses_tpu.ops import pallas_fft as pf  # noqa: E402
from fastgaussianprocesses_tpu.ops import transforms as jtr  # noqa: E402

torch.set_num_threads(2)

N = 1 << 14
TOL_KERNEL = 3e-6     # K1/K2 against their references, relative to the max


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _grad(out, inp, g):
    (gi,) = torch.autograd.grad(out, inp, g)
    return gi


def _rows(seed, R=3, n=N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, n)) + 2.0).astype(np.float32)
    gr, gi = rng.standard_normal((2, R, n)).astype(np.float32)
    return x, (gr + 1j * gi).astype(np.complex64)


def test_pfft_backward_matches_jax_vjp_and_torch_fft():
    """The backward of ``pfft`` on real rows is ``n * pifft_real(g)``: against
    the JAX VJP at ``conj(g)`` and against autograd through ``torch.fft``."""
    x, g = _rows(0)
    xt = torch.from_numpy(x).requires_grad_()
    got = _grad(tp.pfft(xt, N), xt, torch.from_numpy(g)).numpy()
    _, vjp = jax.vjp(lambda v: pf.pfft(v, N), jnp.asarray(x))
    (want_j,) = vjp(jnp.asarray(np.conj(g)))
    assert _max_rel(got, np.asarray(want_j)) < TOL_KERNEL
    perm = torch.as_tensor(tp.spectrum_perm(N))
    x64 = torch.from_numpy(x).double().requires_grad_()
    lib = torch.fft.fft(x64).index_select(-1, perm)
    want_t = _grad(lib, x64, torch.from_numpy(g).to(torch.complex128)).numpy()
    assert _max_rel(got, want_t) < TOL_KERNEL


def test_pifft_real_backward_matches_jax_vjp_and_torch_fft():
    """The backward of ``pifft_real`` is ``pfft(g) / n`` on the real
    cotangent: against the JAX VJP of ``Re(pifft)`` (conjugated back) and
    against autograd through ``torch.fft.ifft``."""
    x, X = _rows(1)
    g = x - 2.0
    Xt = torch.from_numpy(X).requires_grad_()
    got = _grad(tp.pifft_real(Xt, N), Xt, torch.from_numpy(g)).numpy()
    _, vjp = jax.vjp(lambda v: jnp.real(pf.pifft(v, N)), jnp.asarray(X))
    (want_j,) = vjp(jnp.asarray(g))
    assert _max_rel(got, np.conj(np.asarray(want_j))) < TOL_KERNEL
    inv_perm = torch.argsort(torch.as_tensor(tp.spectrum_perm(N)))
    X128 = torch.from_numpy(X).to(torch.complex128).requires_grad_()
    lib = torch.fft.ifft(X128.index_select(-1, inv_perm)).real
    want_t = _grad(lib, X128, torch.from_numpy(g).double()).numpy()
    assert _max_rel(got, want_t) < TOL_KERNEL


def test_unsupported_backwards_raise():
    """``pfft`` of complex rows has a backward now (K2 with complex output):
    the gradient of ``sum |pfft(X)|`` equals autograd's through
    ``torch.fft``; ``pfft_quad`` has none and raises rather than return a
    wrong or missing gradient."""
    _, X = _rows(2, R=1)
    Xt = torch.from_numpy(X).requires_grad_()
    tp.pfft(Xt, N).abs().sum().backward()
    X128 = torch.from_numpy(X).to(torch.complex128).requires_grad_()
    torch.fft.fft(X128).abs().sum().backward()
    assert _max_rel(Xt.grad.numpy(), X128.grad.numpy()) < TOL_KERNEL
    x = torch.ones(1, N, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tp.pfft_quad(x, torch.ones(N), N)


@pytest.mark.parametrize("R", [1, 3])
def test_pifft_and_pifft_ortho_match_jax(R):
    """K2 with complex output: ``pifft`` (the plain version, which the
    wrapper runs on the CPU) and ``pifft_emulate`` (the kernel's algorithm)
    against the JAX ``pifft`` (Pallas, interpret mode) and float64 numpy;
    ``transforms.pifft_ortho`` against the JAX one."""
    _, X = _rows(7 + R, R=R)
    want = np.asarray(pf.pifft(jnp.asarray(X), N))
    inv_perm = np.argsort(tp.spectrum_perm(N))
    exact = np.fft.ifft(X.astype(np.complex128)[:, inv_perm], axis=-1)
    got = tp.pifft(torch.from_numpy(X), N).numpy()
    emu = tp.pifft_emulate(torch.from_numpy(X), N).numpy()
    assert got.dtype == np.complex64 and got.shape == (R, N)
    for a in (got, emu, want):
        assert _max_rel(a, exact) < TOL_KERNEL
    assert _max_rel(got, want) < TOL_KERNEL and _max_rel(emu, want) < TOL_KERNEL
    ortho = ttr.pifft_ortho(torch.from_numpy(X), N).numpy()
    assert _max_rel(ortho, np.asarray(jtr.pifft_ortho(jnp.asarray(X), N))) < TOL_KERNEL


@pytest.mark.parametrize("R", [1, 3])
def test_complex_backwards_match_jax_vjp_and_torch_fft(R):
    """The backward of ``pfft`` on complex rows is ``n * pifft(g)`` and that
    of ``pifft`` is ``pfft(g) / n``: against the JAX VJPs at ``conj(g)``,
    conjugated back, and against autograd through ``torch.fft``."""
    x, Z = _rows(11 + R, R=R)
    _, G = _rows(13 + R, R=R)
    perm = torch.as_tensor(tp.spectrum_perm(N))
    for op, jop, lib in (
            (tp.pfft, pf.pfft, lambda v: torch.fft.fft(v).index_select(-1, perm)),
            (tp.pifft, pf.pifft, lambda v: torch.fft.ifft(v.index_select(-1, torch.argsort(perm))))):
        zt = torch.from_numpy(Z).requires_grad_()
        got = _grad(op(zt, N), zt, torch.from_numpy(G)).numpy()
        _, vjp = jax.vjp(lambda v: jop(v, N), jnp.asarray(Z))
        (want_j,) = vjp(jnp.asarray(np.conj(G)))
        assert _max_rel(got, np.conj(np.asarray(want_j))) < TOL_KERNEL
        z128 = torch.from_numpy(Z).to(torch.complex128).requires_grad_()
        want_t = _grad(lib(z128), z128, torch.from_numpy(G).to(torch.complex128)).numpy()
        assert _max_rel(got, want_t) < TOL_KERNEL


@pytest.mark.parametrize("with_mean", [False, True])
def test_fwht_backward_matches_jax_vjp_f64(with_mean):
    """``fwht(x, mean)``: ``grad_x = fwht(g)``, ``grad_mean = -sqrt(n) g[..., 0]``,
    against the JAX VJP of ``fwht(x - mean)`` in float64."""
    rng = np.random.default_rng(3)
    n = 1 << 10
    x, g = rng.standard_normal((2, 3, n))
    m = rng.standard_normal(3)
    xt, mt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(m).requires_grad_()
    if with_mean:
        gx, gm = torch.autograd.grad(tf.fwht(xt, mt), (xt, mt), torch.from_numpy(g))
        _, vjp = jax.vjp(lambda a, b: jtr.fwht(a - b[:, None]), jnp.asarray(x), jnp.asarray(m))
        wx, wm = vjp(jnp.asarray(g))
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-12)
    else:
        gx = _grad(tf.fwht(xt), xt, torch.from_numpy(g))
        _, vjp = jax.vjp(jtr.fwht, jnp.asarray(x))
        (wx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0,
                               atol=1e-12 * float(np.abs(np.asarray(wx)).max()))


def _hadamard(n):
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / math.sqrt(n)


def _bitrev(n):
    return ttr.bitrev_index(n, torch.device("cpu"))


@pytest.mark.parametrize("name", ["ft_stable_fwht", "rfft_stable_lattice", "irfft_br",
                                  "ft_stable_lattice", "ift_stable_lattice"])
def test_stabilized_transforms_backward_f64(name):
    """Gradients through the transforms with their in-place DC bumps and
    scalings, against the same maps written with dense matrices or plain
    ``torch.fft`` and no in-place update, float64, 1e-12 of the max."""
    n = 256
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, n)) + 1.5)
    fwd = getattr(ttr, name)
    ref = {
        "ft_stable_fwht": lambda v: v @ torch.from_numpy(_hadamard(n)),
        "rfft_stable_lattice": lambda v: torch.fft.rfft(v[:, _bitrev(n)], norm="ortho"),
        "irfft_br": lambda v: torch.fft.irfft(v, n, norm="ortho")[:, _bitrev(n)],
        "ft_stable_lattice": lambda v: torch.fft.fft(v[:, _bitrev(n)], norm="ortho"),
        "ift_stable_lattice": lambda v: torch.fft.ifft(v, norm="ortho")[:, _bitrev(n)],
    }[name]
    if name == "irfft_br":
        x = torch.fft.rfft(x)
        fwd = lambda v: ttr.irfft_br(v, n)  # noqa: E731
    elif name == "ift_stable_lattice":
        x = torch.fft.fft(x)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = fwd(a), ref(b)
    assert _max_rel(ya.detach().numpy(), yb.detach().numpy()) < 1e-12
    g = torch.from_numpy(rng.standard_normal(tuple(ya.shape))).to(ya.dtype)
    if ya.is_complex():
        g = g + 1j * torch.from_numpy(rng.standard_normal(tuple(ya.shape)))
    assert _max_rel(_grad(ya, a, g).numpy(), _grad(yb, b, g).numpy()) < 1e-12


def test_pfft_stable_and_pifft_ortho_real_backward_f32():
    """The permuted-spectrum wrappers (DC bump, in-place scalings) in float32
    against ``torch.fft`` in float64, at the kernels' tolerance."""
    x, g = _rows(5)
    perm = torch.as_tensor(tp.spectrum_perm(N))
    xt = torch.from_numpy(x).requires_grad_()
    got = _grad(ttr.pfft_stable(xt), xt, torch.from_numpy(g)).numpy()
    x64 = torch.from_numpy(x).double().requires_grad_()
    want = _grad(torch.fft.fft(x64, norm="ortho").index_select(-1, perm), x64,
                 torch.from_numpy(g).to(torch.complex128)).numpy()
    assert _max_rel(got, want) < TOL_KERNEL
    Z = torch.from_numpy(g).requires_grad_()
    got = _grad(ttr.pifft_ortho_real(Z, N), Z, torch.from_numpy(x)).numpy()
    Z128 = torch.from_numpy(g).to(torch.complex128).requires_grad_()
    ref = torch.fft.ifft(Z128.index_select(-1, torch.argsort(perm)), norm="ortho").real
    want = _grad(ref, Z128, torch.from_numpy(x).double()).numpy()
    assert _max_rel(got, want) < TOL_KERNEL


@pytest.mark.parametrize("d", [8, 17])
def test_kernel_from_parts_t_value_and_grad_matches_jax_f64(d):
    """The contraction and its scale and lengthscale gradients against the
    JAX package (d = 8: its ``_prod_terms_t`` custom VJP; d = 17, above
    ``_PROD_VJP_MAX_D``: ``jnp.prod``), with derivative orders so that both
    indicator values occur, and a batch of two lengthscale rows."""
    rng = np.random.default_rng(d)
    n = 128
    beta0 = np.zeros((2, d), dtype=np.int64)
    beta1 = np.zeros((2, d), dtype=np.int64)
    beta0[1, 0] = beta1[1, 1] = 1
    c0, c1 = np.array([1.0, 0.5]), np.array([1.0, -2.0])
    parts = rng.uniform(-1.0, 1.0, size=(2, 2, d, n))
    scale = np.array([[1.3], [0.7]])
    ls = rng.uniform(0.5, 2.0, size=(2, d))
    gout = rng.standard_normal((2, n))

    def jloss(s, l):
        k = js.kernel_from_parts_t(jnp.asarray(parts), beta0, beta1, c0, c1, s, l)
        return jnp.sum(k * gout), k

    (_, kj), (gs_j, gl_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(scale), jnp.asarray(ls))
    st = torch.from_numpy(scale).requires_grad_()
    lt = torch.from_numpy(ls).requires_grad_()
    kt = ts.kernel_from_parts_t(torch.from_numpy(parts), beta0, beta1, c0, c1, st, lt)
    gs_t, gl_t = torch.autograd.grad((kt * torch.from_numpy(gout)).sum(), (st, lt))
    np.testing.assert_allclose(kt.detach().numpy(), np.asarray(kj), rtol=1e-12)
    np.testing.assert_allclose(gs_t.numpy(), np.asarray(gs_j), rtol=1e-12)
    np.testing.assert_allclose(gl_t.numpy(), np.asarray(gl_j), rtol=1e-12)


def test_perm_mll_value_and_grad_signs_match_jax_f32(monkeypatch):
    """The float32 permuted-spectrum MLL (both packages forced onto it at
    n = 2^14) and its gradient, as ``tests/test_pallas_fft.py::
    test_perm_loss_and_grad_matches_half`` holds JAX's: noise 1.0, the value
    within rtol 2e-4, and the sign of every entry above 1e-3 of the largest
    (the differentiated eigenvalue floor makes each backend's gradient that
    of its own floored surface, so values are not compared)."""
    monkeypatch.setenv("FASTGPS_TPU_FORCE_PERM", "1")
    monkeypatch.setenv("FASTGPS_TORCH_FORCE_PERM", "1")
    gj = fj.FastGPLattice(2, seed_for_seq=11, dtype=jnp.float32, noise=1.0,
                          requires_grad_noise=True)
    gt = ft.FastGPLattice(2, seed_for_seq=11, dtype=torch.float32, noise=1.0,
                          requires_grad_noise=True, device="cpu")
    x = np.asarray(gj.get_x_next(N))
    y = (np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1)).astype(np.float32)
    gj.add_y_next(jnp.asarray(y))
    gt.get_x_next(N)
    gt.add_y_next(torch.from_numpy(y))
    const = N * math.log(2 * math.pi)
    (vj, _), grads_j = gj._make_loss_fn("MLL", None, 1, const, 1)(gj._raw_dict(),
                                                                    gj._fit_data())
    assert isinstance(gt._solver_pure(gt._raw_dict(), gt._fit_data()), _PermSpectrumSolver)
    vt, _, grads_t = gt._make_loss_fn("MLL", None, 1, const, 1)(gt._raw_dict(), gt._fit_data())
    np.testing.assert_allclose(float(vt), float(vj), rtol=2e-4)
    for k in ("scale", "lengthscales", "noise"):
        gjk, gtk = np.asarray(grads_j[k]), grads_t[k].numpy()
        big = np.abs(gjk) > 1e-3 * np.abs(gjk).max()
        assert big.any() and (np.sign(gtk[big]) == np.sign(gjk[big])).all(), (k, gtk, gjk)


@pytest.mark.cuda
def test_card_backwards_launch_their_kernels(monkeypatch):
    """On the card each backward launches its kernel (K2 for ``pfft``, K1 for
    ``pifft_real``, K4 for ``fwht``) with the plain versions made to raise,
    and equals the CPU's gradient within the kernels' tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x, g = _rows(6)
    xc = torch.from_numpy(x).requires_grad_()
    cpu = {"pfft": _grad(tp.pfft(xc, N), xc, torch.from_numpy(g))}
    Xc = torch.from_numpy(g).requires_grad_()
    cpu["pifft_real"] = _grad(tp.pifft_real(Xc, N), Xc, torch.from_numpy(x))
    xc = torch.from_numpy(x).requires_grad_()
    cpu["fwht"] = _grad(tf.fwht(xc), xc, torch.from_numpy(x))

    def refuse(*a, **k):
        raise AssertionError("the card path reached a plain version")

    for mod, name in ((tp, "pfft_plain"), (tp, "pifft_real_plain"), (tf, "fwht_plain")):
        monkeypatch.setattr(mod, name, refuse)
    tp.reset_launches()
    tf.reset_launches()
    dev = torch.device("cuda")
    xd = torch.from_numpy(x).to(dev).requires_grad_()
    card = {"pfft": _grad(tp.pfft(xd, N), xd, torch.from_numpy(g).to(dev))}
    assert tp.launches == {"pfft": 1, "pifft_real": 1, "pifft": 0, "quad": 0}
    Xd = torch.from_numpy(g).to(dev).requires_grad_()
    card["pifft_real"] = _grad(tp.pifft_real(Xd, N), Xd, torch.from_numpy(x).to(dev))
    assert tp.launches == {"pfft": 2, "pifft_real": 2, "pifft": 0, "quad": 0}
    xd = torch.from_numpy(x).to(dev).requires_grad_()
    card["fwht"] = _grad(tf.fwht(xd), xd, torch.from_numpy(x).to(dev))
    assert tf.launches == {"fwht": 2}
    for k, tol in (("pfft", TOL_KERNEL), ("pifft_real", TOL_KERNEL),
                   ("fwht", 16 * float(np.finfo(np.float32).eps))):
        assert _max_rel(card[k].cpu().numpy(), cpu[k].numpy()) < tol, k
