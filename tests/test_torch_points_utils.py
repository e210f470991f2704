"""The port's Halton and CBC construction, host point library, Walsh series,
test functions, profiling hooks and checkpoints against the JAX package's,
on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.fit import hmc as th  # noqa: E402
from fastgaussianprocesses_torch.ops import walsh as tw  # noqa: E402
from fastgaussianprocesses_torch.ops.walsh_closed import omega_walsh_closed  # noqa: E402
from fastgaussianprocesses_torch.points import construction as tc  # noqa: E402
from fastgaussianprocesses_torch.points import native  # noqa: E402
from fastgaussianprocesses_torch.points.lattice import LatticeSeq  # noqa: E402
from fastgaussianprocesses_torch.utils import checkpoint as tck  # noqa: E402
from fastgaussianprocesses_torch.utils import profiling  # noqa: E402
from fastgaussianprocesses_torch.utils import test_functions as ttf  # noqa: E402
from fastgaussianprocesses_tpu.fit import hmc as jh  # noqa: E402
from fastgaussianprocesses_tpu.ops import walsh as jw  # noqa: E402
from fastgaussianprocesses_tpu.points import construction as jc  # noqa: E402
from fastgaussianprocesses_tpu.utils import checkpoint as jck  # noqa: E402
from fastgaussianprocesses_tpu.utils import test_functions as jtf  # noqa: E402


@pytest.mark.parametrize("d,seed,randomize", [(1, 7, "PERM"), (5, 11, "PERM"), (12, 123, "PERM"),
                                              (3, 2, "FALSE")])
def test_halton_bit_identical(d, seed, randomize):
    a = ft.Halton(d, seed=seed, randomize=randomize)
    b = fj.Halton(d, seed=seed, randomize=randomize)
    for lo, hi in ((0, 1000), (1000, 1037)):
        assert np.array_equal(a(lo, hi), b(lo, hi))


@pytest.mark.parametrize("m,d", [(3, 2), (7, 5), (10, 8)])
def test_cbc_lattice_bit_identical(m, d):
    z = tc.cbc_lattice(m, d)
    assert np.array_equal(z, jc.cbc_lattice(m, d)) and z.dtype == np.uint64
    gamma = 0.5 ** np.arange(d)
    assert np.array_equal(tc.cbc_lattice(m, d, gamma), jc.cbc_lattice(m, d, gamma))
    assert tc.squared_worst_case_error(z, m) == jc.squared_worst_case_error(z, m)


def test_native_equals_numpy_bit_for_bit():
    """The host library (g++ at first use) against the numpy path: shifted
    and unshifted lattices, at a block not starting at 0 and at the full
    2^m_max range's end."""
    assert native.load() is not None, "g++ is present here, so the library must build"
    for d, seed, randomize in ((4, 3, "SHIFT"), (9, None, "SHIFT"), (3, 1, "FALSE")):
        seq = LatticeSeq(d, seed=seed, randomize=randomize)
        for lo, hi in ((0, 1 << 12), (777, 5000)):
            want = seq.numpy_points(lo, hi)
            assert np.array_equal(native.lattice_natural(seq.gen_vec, lo, hi, seq.shift), want)
            assert np.array_equal(seq(lo, hi), want)
    small = LatticeSeq(2, seed=5, m_max=4)
    assert np.array_equal(small(8, 16), small.numpy_points(8, 16))


@pytest.mark.parametrize("failure", ["unwritable_build_dir", "gxx_timeout", "gxx_error"])
def test_native_build_failure_falls_back_to_numpy(failure, tmp_path, monkeypatch):
    """Where the library cannot be built (its directory cannot be made, g++
    times out or fails), ``build`` returns None and ``LatticeSeq`` serves the
    numpy points instead of raising."""
    import subprocess
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    if failure == "unwritable_build_dir":
        blocker = tmp_path / "file"
        blocker.write_text("")
        monkeypatch.setattr(native, "BUILD_DIR", blocker / "_build")
    else:
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")

        def fake_run(cmd, **kw):
            if failure == "gxx_timeout":
                raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
            return subprocess.CompletedProcess(cmd, 1, "", "error")
        monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native.build() is None
    seq = LatticeSeq(3, seed=2)
    assert np.array_equal(seq(0, 64), seq.numpy_points(0, 64))
    assert native._lib is None and native._tried


@pytest.mark.parametrize("alpha", [1, 2, 3, 4])
def test_omega_walsh_against_closed_form_and_jax(alpha):
    """The series by its transfer recursion equals the JAX package's, the
    port's closed form ``walsh_closed`` (the kernels' evaluator) equals the
    series, and order 1 equals its closed form ``1 - 3 * 2^floor(log2 x)``."""
    t = 30
    rng = np.random.default_rng(alpha)
    xb = np.concatenate([[0, 1, 2, 3, (1 << t) - 1, 1 << (t - 1)],
                         rng.integers(0, 1 << t, size=500)]).astype(np.int64)
    series = tw.omega_walsh(torch.from_numpy(xb), t, alpha)
    want = np.asarray(jw.omega_walsh(jnp.asarray(xb), t, alpha))
    np.testing.assert_allclose(series.numpy(), want, rtol=1e-14, atol=1e-15)
    closed = omega_walsh_closed(torch.from_numpy(xb), t, alpha)
    np.testing.assert_allclose(closed.numpy(), series.numpy(), rtol=1e-12, atol=1e-13)
    if alpha == 1:
        np.testing.assert_allclose(tw.omega_order1_closed_form(torch.from_numpy(xb), t).numpy(),
                                   series.numpy(), rtol=1e-14, atol=1e-15)
    ref = tw.omega_walsh_reference(xb[:40], 10 if alpha > 1 else t, alpha, kmax=1 << 12)
    np.testing.assert_allclose(ref, jw.omega_walsh_reference(xb[:40], 10 if alpha > 1 else t,
                                                             alpha, kmax=1 << 12), rtol=1e-14)


def test_omega_walsh_reference_truncation():
    """The brute-force oracle converges to the recursion (t = 10 bits)."""
    xb = np.arange(0, 1 << 10, 37)
    for alpha in (1, 2):
        want = tw.omega_walsh(torch.from_numpy(xb), 10, alpha).numpy()
        got = tw.omega_walsh_reference(xb, 10, alpha, kmax=1 << 14)
        np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("name", sorted(ttf.SUITE))
def test_test_functions_and_gradient(name):
    """Each suite function and its ``gradient`` (``torch.func.grad`` under
    ``vmap``) against the JAX package's at rtol 1e-12."""
    f_t, d = ttf.SUITE[name]
    f_j, _ = jtf.SUITE[name]
    x = np.random.default_rng(len(name)).uniform(size=(17, d))
    np.testing.assert_allclose(f_t(torch.from_numpy(x)).numpy(), np.asarray(f_j(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(ttf.gradient(f_t)(torch.from_numpy(x)).numpy(),
                               np.asarray(jtf.gradient(f_j)(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-13)


def test_profiling_hooks(tmp_path):
    """``trace`` writes a Chrome trace; ``StepTimer`` records each block."""
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())
    timer = profiling.StepTimer(device="cpu")
    for _ in range(3):
        with timer:
            torch.ones(8).sum()
    timer.record()
    assert len(timer.times) == 4 and timer.mean_ms >= 0.0


def _pair(cls_name, d=2, n=64, **kw):
    jg = getattr(fj, cls_name)(d, seed_for_seq=7, **kw)
    tg = getattr(ft, cls_name)(d, seed_for_seq=7, device="cpu", **kw)
    return jg, tg


@pytest.mark.parametrize("cls_name", ["FastGPLattice", "FastGPDigitalNetB2", "StandardGP"])
def test_state_moves_between_packages(cls_name, tmp_path):
    """A JAX model's ``.npz`` state loads into a fresh port model (built with
    another seed, its caches warm) and serves the JAX model's numbers; the
    port's own state loads into the JAX package and back, with the same
    keys."""
    jg, _ = _pair(cls_name)
    x = np.asarray(jg.get_x_next(64))
    jg.add_y_next(jnp.asarray(np.sin(2 * np.pi * x[:, 0]) + x.sum(1)))
    # parameters moved off their defaults (a JAX fit would only add its compile)
    jg._set_raw({k: v + 0.25 for k, v in jg._raw_dict().items()})
    path = str(tmp_path / "jax.npz")
    jck.save_state(jg, path)
    tg = getattr(ft, cls_name)(2, seed_for_seq=99, device="cpu")
    xt = tg.get_x_next(32)
    tg.add_y_next(torch.cos(xt[:, 0]))
    tg.post_mean(np.full((2, 2), 0.3))
    tck.load_state(tg, path)
    assert all(not c for name, c in vars(tg).items()
               if name.endswith("_cache") and isinstance(c, dict))
    np.testing.assert_array_equal(tg.get_x(0).numpy(), x)
    xq = np.random.default_rng(3).uniform(size=(9, 2))
    (pt, vt), (pj, vj) = tg.post_mean_var(xq), jg.post_mean_var(xq)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-8)
    # variances at 1e-9 of the prior variance (the model's scale), the
    # dense Cholesky's LAPACK rounding (tests/test_torch_standard_gp.py)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8,
                               atol=1e-9 * float(tg.scale[0]))
    path2 = str(tmp_path / "torch.npz")
    tck.save_state(tg, path2)
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    jg2, _ = _pair(cls_name)
    jck.load_state(jg2, path2)
    np.testing.assert_allclose(np.asarray(jg2.post_mean(xq)), np.asarray(pj), rtol=1e-8)


def _gp_pair():
    jg, tg = _pair("FastGPLattice")
    x = np.asarray(jg.get_x_next(64))
    tg.get_x_next(64)
    y = np.sin(2 * np.pi * x[:, 0])
    jg.add_y_next(jnp.asarray(y))
    tg.add_y_next(torch.from_numpy(y))
    return jg, tg


def test_hmc_token_moves_between_packages(tmp_path):
    """HMC resume tokens cross between the packages: a token the JAX package
    saved resumes in the port (on the JAX package's draws) to the JAX
    package's own resumed run; the port saves it back unchanged for the JAX
    package, and the port's own token after the same first leg holds the same
    keys, shapes and dtypes, with values as close as the two first legs are
    (their GP log-densities round differently, ~1e-8 after 10 iterations).
    GP hyperposterior of a lattice, 2 chains, 6 warmup and 4 + 4 samples."""
    from test_torch_hmc import jax_draws
    jg, tg = _gp_pair()
    kw = dict(num_warmup=6, num_chains=2, seed=3, mass_matrix="dense", trajectory_adapt="fixed",
              num_leapfrog=4, trajectory_jitter=0.0)
    part, _ = jh.sample_gp_hyperposterior(jg, num_samples=4, **kw)
    jpath = str(tmp_path / "jax_token.npz")
    jck.save_hmc_state(part.state, jpath)
    want, _ = jh.sample_gp_hyperposterior(jg, num_samples=4, resume_state=jck.load_hmc_state(jpath),
                                          **kw)
    logprob, init = th.gp_log_density(tg)
    dim = sum(v.numel() for v in init.values())
    hkw = dict(num_warmup=6, num_chains=2, mass_matrix="dense", trajectory_adapt="fixed",
               num_leapfrog=4, target_accept=0.9, _draw_fn=jax_draws(3, 2, dim, None))
    rest = th.hmc(logprob, init, 3, num_samples=4, init_state=tck.load_hmc_state(jpath), **hkw)
    np.testing.assert_allclose(rest.log_prob.numpy(), np.asarray(want.log_prob), rtol=1e-9)
    for k in init:
        np.testing.assert_allclose(rest.samples[k].numpy(), np.asarray(want.samples[k]),
                                   rtol=1e-9)
    # the JAX token through the port's load and save, back in the JAX package
    back = str(tmp_path / "back.npz")
    tck.save_hmc_state(tck.load_hmc_state(jpath), back)
    (c_j, t_j), (c_b, t_b) = jck.load_hmc_state(jpath), jck.load_hmc_state(back)
    assert t_j == t_b and len(c_j) == len(c_b)
    for a, b in zip(c_j, c_b):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    # the port's own first leg (JAX draws), saved by the port
    first = th.hmc(logprob, init, 3, num_samples=4, **hkw)
    tpath = str(tmp_path / "torch_token.npz")
    tck.save_hmc_state(first.state, tpath)
    (c_t, t_t) = jck.load_hmc_state(tpath)
    assert t_t == t_j and len(c_t) == len(c_j)
    for a, b in zip(c_j, c_t):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-7, atol=1e-12)
