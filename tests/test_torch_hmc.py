"""The port's HMC hyperposterior (``fastgaussianprocesses_torch/fit/hmc.py``)
against the JAX package's, on the CPU.

* The diagnostics (split-R-hat, rank-normalized ESS) on fixed arrays.
* The sampler, fed the JAX key schedule's draws through its private
  ``_draw_fn``, reproduces JAX ``hmc``'s samples, log-densities, acceptance,
  step size, mass estimate and mean leapfrog count (float64, a correlated
  3-D Gaussian target whose value and gradient are computed by the same
  elementwise formulas in both packages).  XLA's CPU code fuses multiply-adds
  that PyTorch rounds twice, so the two runs differ by ulps from the first
  step, and dual averaging amplifies what moves the acceptance: with the
  acceptance target 0.95 its gain stays small enough for 1e-9 over 30 + 20
  iterations (at 0.8 the two runs drift apart by 1e-4 and more on the
  CPU).
* Resume is bit for bit.
* Each chain's GP log-density and gradient equal
  ``jax.vmap(jax.value_and_grad(logprob))`` (jitted, as its ``hmc`` runs
  it) of the JAX package's ``sample_gp_hyperposterior`` log-density
  (captured by a stub ``hmc``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402
from fastgaussianprocesses_torch.fit import hmc as th  # noqa: E402
from fastgaussianprocesses_tpu.fit import hmc as jh  # noqa: E402

COV = np.array([[1.0, 0.8, 0.3], [0.8, 2.0, -0.5], [0.3, -0.5, 0.7]])
PREC = np.linalg.inv(COV)
MU = np.array([0.5, -1.0, 2.0])
C, WARM, SAMPLES, SEED = 4, 30, 20, 3
MODES = {  # (hmc options, the trajectory draw each step takes)
    "dense_chees": (dict(mass_matrix="dense", trajectory_adapt="chees"), "uniform"),
    "diag_fixed_jitter": (dict(mass_matrix="diag", trajectory_adapt="fixed",
                               trajectory_jitter=0.5), (4, 8)),
    "dense_fixed": (dict(mass_matrix="dense", trajectory_adapt="fixed"), None),
}
COMMON = dict(num_leapfrog=8, mass_decay=0.9, target_accept=0.95)


def _quad(v):
    w = [PREC[i, 0] * v[0] + PREC[i, 1] * v[1] + PREC[i, 2] * v[2] for i in range(3)]
    return -0.5 * (v[0] * w[0] + v[1] * w[1] + v[2] * w[2])


def _quad_grad(v):
    return [-(PREC[i, 0] * v[0] + PREC[i, 1] * v[1] + PREC[i, 2] * v[2]) for i in range(3)]


@jax.custom_vjp
def _jq(v):
    return _quad([v[0], v[1], v[2]])


_jq.defvjp(lambda v: (_jq(v), v),
           lambda v, ct: (jnp.stack(_quad_grad([v[0], v[1], v[2]])) * ct,))


def _jax_logprob(q):
    return _jq(jnp.stack([q["a"][0] - MU[0], q["b"][0] - MU[1], q["b"][1] - MU[2]]))


class _TQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return _quad([v[:, 0], v[:, 1], v[:, 2]])

    @staticmethod
    def backward(ctx, ct):
        v, = ctx.saved_tensors
        return torch.stack(_quad_grad([v[:, 0], v[:, 1], v[:, 2]]), -1) * ct[:, None]


def _torch_logprob(q):
    return _TQ.apply(torch.stack([q["a"][:, 0] - MU[0], q["b"][:, 0] - MU[1],
                                  q["b"][:, 1] - MU[2]], -1))


INIT = {"a": np.zeros(1), "b": np.zeros(2)}


def jax_draws(seed, num_chains, dim, traj):
    """The JAX ``hmc``'s draws, from its key schedule (``split`` of the seed's
    key into the initial and the run key; ``fold_in(k_run, t)`` split in
    three a step), in the port's ``_draw_fn`` form."""
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    f64 = jnp.float64

    def draw(t):
        if t < 0:
            return {"init": torch.tensor(np.asarray(
                jax.random.normal(k_init, (num_chains, dim), dtype=f64)))}
        kp, kl, ku = jax.random.split(jax.random.fold_in(k_run, t), 3)
        if traj == "uniform":
            tr = torch.tensor(np.asarray(jax.random.uniform(kl, (), dtype=f64)))
        elif traj is None:
            tr = None
        else:
            tr = int(jax.random.randint(kl, (), traj[0], traj[1] + 1))
        z = jax.random.normal(kp, (num_chains, dim), dtype=f64)
        accept_u = jax.random.uniform(ku, (num_chains,), dtype=f64)
        return {"z": torch.tensor(np.asarray(z)), "traj": tr,
                "accept_u": torch.tensor(np.asarray(accept_u))}
    return draw


_JAX_RUNS = {}


def _jax_run(mode, num_warmup=WARM, num_samples=SAMPLES, init_state=None):
    key = (mode, num_warmup, num_samples, init_state is not None)
    if key not in _JAX_RUNS:
        kw, _ = MODES[mode]
        _JAX_RUNS[key] = jh.hmc(_jax_logprob, {k: jnp.asarray(v) for k, v in INIT.items()},
                                SEED, num_samples=num_samples, num_warmup=num_warmup,
                                num_chains=C, init_state=init_state, **kw, **COMMON)
    return _JAX_RUNS[key]


def _torch_run(mode, num_warmup=WARM, num_samples=SAMPLES, init_state=None, jax_keys=True):
    kw, traj = MODES[mode]
    draw = jax_draws(SEED, C, 3, traj) if jax_keys else None
    return th.hmc(_torch_logprob, {k: torch.from_numpy(v) for k, v in INIT.items()}, SEED,
                  num_samples=num_samples, num_warmup=num_warmup, num_chains=C,
                  init_state=init_state, _draw_fn=draw, **kw, **COMMON)


def _assert_same_run(rt, rj, rtol=1e-9):
    for k in INIT:
        np.testing.assert_allclose(rt.samples[k].numpy(), np.asarray(rj.samples[k]), rtol=rtol)
        np.testing.assert_allclose(rt.mass_diag[k].numpy(), np.asarray(rj.mass_diag[k]),
                                   rtol=rtol)
    np.testing.assert_allclose(rt.log_prob.numpy(), np.asarray(rj.log_prob), rtol=rtol)
    np.testing.assert_allclose(float(rt.step_size), float(rj.step_size), rtol=rtol)
    # the JAX package averages the acceptances in float32, so its rate carries
    # float32 rounding: compare the number of accepted proposals, exactly
    draws = rt.log_prob.numel()
    assert round(float(rt.accept_rate) * draws) == round(float(rj.accept_rate) * draws)
    np.testing.assert_allclose(float(rt.accept_rate), float(rj.accept_rate), rtol=1e-7)
    np.testing.assert_allclose(rt.mean_leapfrog, rj.mean_leapfrog, rtol=rtol)


def test_diagnostics_match_jax():
    """split-R-hat and bulk ESS equal the JAX package's to 1e-12 on fixed
    draws: well mixed, one chain offset (R-hat > 1), autocorrelated, ties."""
    rng = np.random.default_rng(4)
    mixed = rng.standard_normal((200, 4))
    offset = mixed + np.array([0.0, 0.0, 0.0, 3.0])
    ar = np.zeros((200, 4))
    for i in range(1, 200):
        ar[i] = 0.9 * ar[i - 1] + rng.standard_normal(4)
    ties = np.round(mixed, 1)
    for x in (mixed, offset, ar, ties):
        np.testing.assert_allclose(th.split_rhat(x), jh.split_rhat(x), rtol=1e-12)
        np.testing.assert_allclose(th.effective_sample_size(x), jh.effective_sample_size(x),
                                   rtol=1e-12)
        np.testing.assert_allclose(th.effective_sample_size(x, rank_normalized=False),
                                   jh.effective_sample_size(x, rank_normalized=False),
                                   rtol=1e-12)
    assert th.split_rhat(offset) > 1.2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_hmc_matches_jax_on_its_draws(mode):
    _assert_same_run(_torch_run(mode), _jax_run(mode))


def test_resume_is_bit_for_bit():
    """A run cut after 8 of its 20 samples and resumed from its token (the
    port's own draws) equals the uninterrupted run bit for bit; past warmup
    the resumed run adapts no further."""
    mode = "dense_chees"
    full = _torch_run(mode, jax_keys=False)
    part = _torch_run(mode, num_samples=8, jax_keys=False)
    assert part.state[1] == WARM + 8
    rest = _torch_run(mode, num_samples=12, init_state=part.state, jax_keys=False)
    assert rest.state[1] == WARM + SAMPLES
    for k in INIT:
        assert torch.equal(torch.cat([part.samples[k], rest.samples[k]]), full.samples[k])
    assert torch.equal(torch.cat([part.log_prob, rest.log_prob]), full.log_prob)
    for a, b in zip(rest.state[0], full.state[0]):
        assert torch.equal(a, b)
    assert torch.equal(rest.step_size, part.step_size)


def test_chain_sharding_refuses_a_non_sharding():
    """Chains over devices are ported (``tests/test_torch_parallel.py`` runs
    them on four ranks); what is not a ``parallel.mesh`` sharding is refused."""
    with pytest.raises(TypeError, match="chain_sharding must be"):
        th.hmc(_torch_logprob, {k: torch.from_numpy(v) for k, v in INIT.items()}, 0,
               num_samples=1, num_warmup=0, num_chains=2, chain_sharding=object())


class _Captured(Exception):
    pass


def jax_gp_logprob(gp, monkeypatch, **kw):
    """The JAX package's hyperposterior log-density and initial leaves, taken
    from the ``hmc`` call of its ``sample_gp_hyperposterior``."""
    got = {}

    def capture(logprob, init, *a, **k):
        got["logprob"], got["init"] = logprob, init
        raise _Captured

    monkeypatch.setattr(jh, "hmc", capture)
    with pytest.raises(_Captured):
        jh.sample_gp_hyperposterior(gp, **kw)
    return got["logprob"], got["init"]


def _compare_chains(jgp, tgp, monkeypatch, chains, seed=0, spread=0.3, **kw):
    """Each chain's log-density and gradient at ``chains`` random raw points."""
    jlp, j0 = jax_gp_logprob(jgp, monkeypatch, **kw)
    tlp, t0 = th.gp_log_density(tgp, **kw)
    assert sorted(t0) == sorted(j0)
    rng = np.random.default_rng(seed)
    pts = {k: np.asarray(v)[None] + spread * rng.standard_normal((chains,) + np.shape(v))
           for k, v in j0.items()}
    dt = tgp.dtype
    vj, gj = jax.jit(jax.vmap(jax.value_and_grad(jlp)))(
        {k: jnp.asarray(v, dtype=jnp.asarray(j0[k]).dtype) for k, v in pts.items()})
    leaves = {k: torch.tensor(v, dtype=dt, requires_grad=True) for k, v in pts.items()}
    vt = tlp(leaves)
    assert vt.shape == (chains,)
    gt = dict(zip(leaves, torch.autograd.grad(vt.sum(), list(leaves.values()))))
    return vt.detach().numpy(), np.asarray(vj), {k: (gt[k].numpy(), np.asarray(gj[k]))
                                                 for k in leaves}


def _models(cls_name, d=2, n=1 << 6, **kw):
    jg = getattr(fj, cls_name)(d, seed_for_seq=7, **kw)
    tg = getattr(ft, cls_name)(d, seed_for_seq=7, device="cpu", **kw)
    x = np.asarray(jg.get_x_next(n))
    tg.get_x_next(n)
    y = np.sin(2 * np.pi * x[:, 0]) + x.sum(1)
    jg.add_y_next(jnp.asarray(y))
    tg.add_y_next(torch.from_numpy(y))
    return jg, tg


@pytest.mark.parametrize("cls_name", ["FastGPLattice", "FastGPDigitalNetB2", "StandardGP"])
def test_gp_log_density_per_chain_matches_jax_vmap(cls_name, monkeypatch):
    """n = 2^6, d = 2, float64, 3 chains (scale and lengthscales sampled):
    every chain's value and gradient at rtol 1e-10 (the dense model's
    Cholesky, one factor a chain, at 1e-9: its LAPACK differs from the JAX
    package's by ulps, ``tests/test_torch_standard_gp.py``)."""
    rtol = 1e-9 if cls_name == "StandardGP" else 1e-10
    jg, tg = _models(cls_name)
    vt, vj, grads = _compare_chains(jg, tg, monkeypatch, 3)
    np.testing.assert_allclose(vt, vj, rtol=rtol)
    for k, (a, b) in grads.items():
        np.testing.assert_allclose(a, b, rtol=rtol, err_msg=k)


def test_gp_log_density_adaptive_nugget_two_tasks(monkeypatch):
    """A 2-task digital net with ``adaptive_nugget`` (its trace ratios are
    per chain), the noise sampled too: 3 chains at rtol 1e-10."""
    jg = fj.FastGPDigitalNetB2(2, num_tasks=2, seed_for_seq=7, adaptive_nugget=True,
                               noise=1e-3)
    tg = ft.FastGPDigitalNetB2(2, num_tasks=2, seed_for_seq=7, adaptive_nugget=True,
                               noise=1e-3, device="cpu")
    xs = [np.asarray(x) for x in jg.get_x_next([32, 16], task=[0, 1])]
    tg.get_x_next([32, 16], task=[0, 1])
    ys = [np.sin(2 * np.pi * xs[0][:, 0]), 0.5 * np.cos(2 * np.pi * xs[1][:, 1])]
    jg.add_y_next([jnp.asarray(y) for y in ys], task=[0, 1])
    tg.add_y_next([torch.from_numpy(y) for y in ys], task=[0, 1])
    vt, vj, grads = _compare_chains(jg, tg, monkeypatch, 3,
                                    include=("scale", "lengthscales", "noise"))
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    for k, (a, b) in grads.items():
        np.testing.assert_allclose(a, b, rtol=1e-10, err_msg=k)


def test_gp_log_density_float32_perm_path(monkeypatch):
    """The float32 permuted-spectrum path (both packages forced onto it) at
    n = 2^14 with 2 chains, at ``test_torch_autograd_ops.py``'s float32 MLL
    tolerances: each chain's value within rtol 2e-4, and the sign of every
    gradient entry above 1e-3 of the largest (each backend differentiates its
    own floored surface)."""
    monkeypatch.setenv("FASTGPS_TPU_FORCE_PERM", "1")
    monkeypatch.setenv("FASTGPS_TORCH_FORCE_PERM", "1")
    jg = fj.FastGPLattice(2, seed_for_seq=11, dtype=jnp.float32, noise=1.0)
    tg = ft.FastGPLattice(2, seed_for_seq=11, dtype=torch.float32, noise=1.0, device="cpu")
    n = 1 << 14
    x = np.asarray(jg.get_x_next(n))
    tg.get_x_next(n)
    y = (np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1)).astype(np.float32)
    jg.add_y_next(jnp.asarray(y))
    tg.add_y_next(torch.from_numpy(y))
    from fastgaussianprocesses_torch.models.fast import _PermSpectrumSolver
    assert isinstance(tg._solver_pure(tg._raw_dict(), tg._fit_data()), _PermSpectrumSolver)
    vt, vj, grads = _compare_chains(jg, tg, monkeypatch, 2)
    np.testing.assert_allclose(vt, vj, rtol=2e-4)
    for k, (a, b) in grads.items():
        for c in range(2):
            big = np.abs(b[c]) > 1e-3 * np.abs(b[c]).max()
            assert big.any() and (np.sign(a[c][big]) == np.sign(b[c][big])).all(), (k, a, b)


def test_hyperposterior_example():
    """The port's ``examples/hyperposterior`` at ``tests/test_examples.py``'s size."""
    from fastgaussianprocesses_torch.examples import hyperposterior
    assert hyperposterior.main(n=1 << 6, num_samples=50, num_chains=2, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cls_name,counter,per_grad", [
    ("FastGPLattice", "perm", {"pfft": 1, "pifft_real": 1}),
    ("FastGPDigitalNetB2", "fwht", {"fwht": 2})])
def test_card_hmc_gradient_launches_once_for_all_chains(cls_name, counter, per_grad,
                                                        monkeypatch):
    """On the card (float32, n = 2^14) one HMC gradient of 8 chains launches
    K1 and K2 once each (lattice) or K4 twice, forward and backward (digital
    net), every launch on 8 rows, with the plain versions made to raise; and
    each chain's value equals the CPU's float32 within 5e-5.  Noise 1.0, so
    that the eigenvalue floor does not decide the float32 surface (at the
    default noise the two float32 FFTs' rounding moved the values by 4e-4
    on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fastgaussianprocesses_torch.ops import fwht as tf
    from fastgaussianprocesses_torch.ops import perm_fft as tp
    n, chains = 1 << 14, 8
    gps = []
    for device in ("cpu", "cuda"):
        monkeypatch.setenv("FASTGPS_TORCH_FORCE_PERM", "1")
        gp = getattr(ft, cls_name)(4, seed_for_seq=7, alpha=2, dtype=torch.float32,
                                   noise=1.0, device=device)
        x = gp.get_x_next_host(n)
        gp.add_y_next(np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1))
        gps.append(gp)
    rng = np.random.default_rng(0)
    lp_cpu, init = th.gp_log_density(gps[0])
    pts = {k: v.numpy()[None] + 0.3 * rng.standard_normal((chains,) + tuple(v.shape))
           for k, v in init.items()}
    want = lp_cpu({k: torch.tensor(v, dtype=torch.float32) for k, v in pts.items()})
    lp, _ = th.gp_log_density(gps[1])
    rows = []

    def refuse(*a, **k):
        raise AssertionError("the card path reached a plain version")

    for mod, name in ((tp, "pfft_plain"), (tp, "pifft_real_plain"), (tf, "fwht_plain")):
        monkeypatch.setattr(mod, name, refuse)
    orig = {"pfft": tp._pfft_cuda, "pifft_real": tp._pifft_real_cuda, "fwht": tf._fwht_cuda}

    def spy(name):
        def f(x, *a, **k):
            rows.append((name, x.numel() // x.shape[-1]))
            return orig[name](x, *a, **k)
        return f

    monkeypatch.setattr(tp, "_pfft_cuda", spy("pfft"))
    monkeypatch.setattr(tp, "_pifft_real_cuda", spy("pifft_real"))
    monkeypatch.setattr(tf, "_fwht_cuda", spy("fwht"))
    leaves = {k: torch.tensor(v, dtype=torch.float32, device="cuda", requires_grad=True)
              for k, v in pts.items()}
    val = lp(leaves)
    torch.autograd.grad(val.sum(), list(leaves.values()))
    torch.cuda.synchronize()
    got = {}
    for name, r in rows:
        assert r == chains, rows
        got[name] = got.get(name, 0) + 1
    assert got == per_grad, rows
    np.testing.assert_allclose(val.detach().cpu().numpy(), want.numpy(), rtol=5e-5)
