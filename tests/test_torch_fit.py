"""Port parity for the fit step: ``fit`` on single-task FastGPLattice
(half-spectrum solver) and FastGPDigitalNetB2 (general solver) in float64
against the JAX package, side by side and against the pinned goldens of
``tests/test_goldens.py``; its options (steps per dispatch, the fused fit
``steps_per_dispatch=-1``, checkpoints, trainable flags) and what it
refuses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fastgaussianprocesses_torch as ft  # noqa: E402
import fastgaussianprocesses_tpu as fj  # noqa: E402

torch.set_num_threads(2)

# tests/test_goldens.py (seed 42, n = 64, d = 2, 10 iterations, float64)
GOLDEN = {
    "lattice": dict(loss0=-57.519847758390696, loss_end=-32.94052104844358,
                    l2=0.15396267216851256, cm1=0.9995304019716154,
                    cv1=4.2319050858052876e-05),
    "dnb2": dict(loss0=-53.41048530985256, loss_end=-40.09784084708501,
                 l2=0.14516682267997252, cm1=1.0077280294740882,
                 cv1=0.00034703122761881033),
}
CLASSES = {"lattice": (ft.FastGPLattice, fj.FastGPLattice),
           "dnb2": (ft.FastGPDigitalNetB2, fj.FastGPDigitalNetB2)}


def _f(x):
    x = np.asarray(x)
    return np.sin(2 * np.pi * x[:, 0]) + np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _pair(name, n=64, seed=42, **kw):
    """The port's model and the JAX package's on the same points and data."""
    ct, cj = CLASSES[name]
    gt = ct(2, seed_for_seq=seed, device="cpu", **kw)
    gj = cj(2, seed_for_seq=seed, **kw)
    x = np.asarray(gj.get_x_next(n))
    assert np.array_equal(gt.get_x_next(n).numpy(), x)
    gt.add_y_next(torch.from_numpy(_f(x)))
    gj.add_y_next(jnp.asarray(_f(x)))
    return gt, gj


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_fit_reproduces_golden_and_jax_f64(name):
    g = GOLDEN[name]
    gt, gj = _pair(name)
    dt = gt.fit(iterations=10, verbose=0, store_loss_hist=True)
    dj = gj.fit(iterations=10, verbose=0, store_loss_hist=True)
    lh = dt["loss_hist"]
    np.testing.assert_allclose(lh, np.asarray(dj["loss_hist"]), rtol=1e-8)
    np.testing.assert_allclose(float(lh[0]), g["loss0"], rtol=1e-8)
    np.testing.assert_allclose(float(lh[-1]), g["loss_end"], rtol=1e-8)
    xq = np.random.default_rng(7).uniform(size=(128, 2))
    pm = gt.post_mean(xq).numpy()
    l2 = float(np.linalg.norm(_f(xq) - pm) / np.linalg.norm(_f(xq)))
    np.testing.assert_allclose(l2, g["l2"], rtol=1e-8)
    np.testing.assert_allclose(float(gt.post_cubature_mean()), g["cm1"], rtol=1e-8)
    np.testing.assert_allclose(float(gt.post_cubature_var()), g["cv1"], rtol=1e-8)
    for k in gt.params:
        np.testing.assert_allclose(gt.params[k].raw.numpy(), np.asarray(gj.params[k].raw),
                                   rtol=1e-8, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("metric", ["GCV", "CV"])
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_gcv_and_cv_loss_histories_match_jax_f64(name, metric):
    """GCV and CV (with per-point weights) step for step against the JAX
    package, every history kept.  Both losses are ratios in which the scale
    cancels up to the tiny noise, so its gradient is rounding noise whose
    sign differs between the packages: the scale is not trained here."""
    gt, gj = _pair(name, seed=7, requires_grad_scale=False)
    w = np.random.default_rng(1).uniform(0.5, 1.5, 64) if metric == "CV" else 1
    kw = dict(loss_metric=metric, iterations=6, verbose=0, store_hists=True, cv_weights=w)
    dt, dj = gt.fit(**kw), gj.fit(**kw)
    assert dt["iterations"] == dj["iterations"]
    for k in dj:
        if k != "iterations":
            np.testing.assert_allclose(dt[k], np.asarray(dj[k]), rtol=1e-8, atol=1e-14,
                                       err_msg=k)


def test_steps_per_dispatch_keeps_the_trajectory():
    """K = 4 steps a dispatch (the stop falls inside a chunk) gives the
    histories and parameters of K = 1 exactly."""
    out = []
    for K in (1, 4):
        gt, _ = _pair("lattice", seed=7)
        out.append((gt.fit(iterations=9, verbose=0, store_hists=True, steps_per_dispatch=K),
                    {k: p.raw.numpy() for k, p in gt.params.items()}))
    (d1, r1), (d4, r4) = out
    assert d1["iterations"] == d4["iterations"] == 9
    for k in d1:
        np.testing.assert_array_equal(d1[k], d4[k], err_msg=k)
    for k in r1:
        np.testing.assert_array_equal(r1[k], r4[k], err_msg=k)


def test_checkpoint_resume_continues_exactly(tmp_path):
    """A fit stopped after 8 iterations and resumed from its checkpoint (in
    chunks of 3 steps) follows the uninterrupted fit's trajectory: the same
    histories, from before the stop too, and the same final parameters."""
    def build():
        return _pair("dnb2", seed=7)[0]

    full = build()
    d_full = full.fit(iterations=16, verbose=0, store_hists=True)
    ck = str(tmp_path / "fit.npz")
    build().fit(iterations=8, verbose=0, store_hists=True, checkpoint_path=ck,
                checkpoint_every=8)
    with np.load(ck) as z:
        assert {"best_loss", "save_loss", "waits", "iteration", "raw_scale", "best_scale",
                "ss_scale", "pg_scale", "hist_loss_hist"} <= set(z.files)
    resumed = build()
    d_b = resumed.fit(iterations=16, verbose=0, store_hists=True, resume_from=ck,
                      steps_per_dispatch=3)
    for k in d_full:
        np.testing.assert_array_equal(d_b[k], d_full[k], err_msg=k)
    for k in full.params:
        np.testing.assert_array_equal(resumed.params[k].raw.numpy(),
                                      full.params[k].raw.numpy(), err_msg=k)


def test_untrainable_parameters_stay_put():
    """Noise is untrained by default and lengthscales when asked; flags
    carried over from the JAX package by ``load_jax_params`` count too, and
    fitting leaves no parameter that requires grad."""
    gt, gj = _pair("lattice", seed=7, requires_grad_lengthscales=False)
    assert gt.total_tuneable_parameters == gj.total_tuneable_parameters == 1
    assert gt.total_parameters == gj.total_parameters
    before = {k: p.raw.clone() for k, p in gt.params.items()}
    gt.fit(iterations=3, verbose=0)
    assert not torch.equal(gt.params["scale"].raw, before["scale"])
    for k in ("lengthscales", "noise"):
        assert torch.equal(gt.params[k].raw, before[k]), k
    assert not any(p.raw.requires_grad for p in gt.params.values())
    g2, _ = _pair("lattice", seed=7)
    ft.load_jax_params(g2, {k: np.asarray(v) for k, v in gj._raw_dict().items()},
                       {k: p.trainable for k, p in gj.params.items()})
    assert {k: p.trainable for k, p in g2.params.items()} == \
        {k: p.trainable for k, p in gt.params.items()}


def test_unported_fit_options_raise():
    """``masks`` (once refused) fit only the selected fleet members;
    ``steps_per_dispatch=-1`` (once refused) raises ``ValueError`` with the
    default verbose line, as in the JAX package."""
    gt = ft.FastGPLattice(2, seed_for_seq=7, shape_batch=(2,), shape_lengthscales=(2, 2),
                          device="cpu")
    x = gt.get_x_next_host(32)
    gt.add_y_next(torch.from_numpy(np.stack([_f(x), 2 * _f(x)])))
    before = gt.lengthscales.clone()
    gt.fit(iterations=3, verbose=0, masks=[[1]])
    assert torch.equal(gt.lengthscales[0], before[0])
    assert not torch.equal(gt.lengthscales[1], before[1])
    with pytest.raises(ValueError, match="steps_per_dispatch=-1"):
        gt.fit(iterations=1, steps_per_dispatch=-1)


def _fused_case(kind):
    """A fresh float64 CPU model of ``kind`` and the fit's extra keywords."""
    if kind in ("lattice", "dnb2"):
        gt = CLASSES[kind][0](2, seed_for_seq=42, device="cpu")
        gt.add_y_next(torch.from_numpy(_f(gt.get_x_next_host(64))))
        return gt, {}
    if kind == "multitask":
        gt = ft.FastGPDigitalNetB2(2, num_tasks=2, seed_for_seq=7, device="cpu")
        xs = gt.get_x_next_host([32, 16], task=[0, 1])
        gt.add_y_next([torch.from_numpy(_f(x) + 0.1 * l * np.cos(2 * np.pi * x[:, 1]))
                       for l, x in enumerate(xs)], task=[0, 1])
        return gt, {}
    if kind == "fleet":
        gt = ft.FastGPLattice(2, seed_for_seq=7, shape_batch=(2,), shape_lengthscales=(2, 2),
                              device="cpu")
        x = gt.get_x_next_host(32)
        gt.add_y_next(torch.from_numpy(np.stack([_f(x), 2 * _f(x)])))
        return gt, {"masks": [[1]]}
    gt = ft.StandardGP(2, seed_for_seq=42, device="cpu")
    gt.add_y_next(torch.from_numpy(_f(gt.get_x_next(32))))
    return gt, {}


@pytest.mark.parametrize("kind,metric", [(k, m) for k in ("lattice", "dnb2")
                                         for m in ("MLL", "GCV", "CV")]
                         + [("multitask", "MLL"), ("fleet", "MLL"), ("standard", "MLL")])
def test_fused_fit_equals_unchunked_bit_for_bit(kind, metric):
    """``steps_per_dispatch=-1`` (blocks of 64, one fetch each) against
    K = 1 in float64: the same stop iteration and the same raw
    parameters bit for bit, through early stops, a stop at the iteration cap
    past the first block (70 iterations), a 2-task model, a masked fleet
    and ``StandardGP``."""
    its = 70 if kind in ("lattice", "dnb2") else 25
    out = []
    for K in (1, -1):
        gt, kw = _fused_case(kind)
        d = gt.fit(loss_metric=metric, iterations=its, verbose=0, steps_per_dispatch=K, **kw)
        out.append((d, {k: p.raw.clone() for k, p in gt.params.items()}))
    (d1, r1), (df, rf) = out
    assert d1 == df
    for k in r1:
        assert torch.equal(r1[k], rf[k]), k


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_fused_fit_matches_jax_fused_fit(name):
    """The port's ``steps_per_dispatch=-1`` against the JAX package's on the
    same data: the same iterations, raw parameters to rtol 1e-8."""
    gt, gj = _pair(name)
    dt = gt.fit(iterations=20, verbose=0, steps_per_dispatch=-1)
    dj = gj.fit(iterations=20, verbose=0, steps_per_dispatch=-1)
    assert dt == {"iterations": int(dj["iterations"])}
    for k in gt.params:
        np.testing.assert_allclose(gt.params[k].raw.numpy(), np.asarray(gj.params[k].raw),
                                   rtol=1e-8, atol=1e-12, err_msg=k)


def test_fused_fit_resume_matches_unchunked(tmp_path):
    """A checkpointed fit resumed with ``steps_per_dispatch=-1`` (from the
    checkpoint's iteration, waits, best and save losses) lands on the uninterrupted K = 1 fit's stop iteration and parameters, as
    the JAX package's ``tests/test_fit_metrics.py`` requires of its own."""
    def build():
        gt = ft.FastGPLattice(2, seed_for_seq=29, device="cpu")
        x = gt.get_x_next_host(64)
        gt.add_y_next(torch.from_numpy(np.cos(2 * np.pi * x[:, 1]) + x.sum(1)))
        return gt

    full = build()
    d_full = full.fit(iterations=60, verbose=0)
    ck = str(tmp_path / "ck.npz")
    build().fit(iterations=15, verbose=0, checkpoint_path=ck, checkpoint_every=15)
    resumed = build()
    d_b = resumed.fit(iterations=60, verbose=0, resume_from=ck, steps_per_dispatch=-1)
    assert d_b == {"iterations": d_full["iterations"]}
    for k in full.params:
        assert torch.equal(resumed.params[k].raw, full.params[k].raw), k


@pytest.mark.parametrize("kw", [dict(verbose=1), dict(store_loss_hist=True),
                                dict(store_hists=True), dict(checkpoint_path="unused.npz")])
def test_fused_fit_refuses_per_step_records(kw):
    """``steps_per_dispatch=-1`` keeps nothing per step, so a verbose line,
    histories or a checkpoint raise ``ValueError`` before any step runs."""
    gt, _ = _fused_case("lattice")
    before = {k: p.raw.clone() for k, p in gt.params.items()}
    with pytest.raises(ValueError, match="steps_per_dispatch=-1"):
        gt.fit(iterations=3, steps_per_dispatch=-1, **{"verbose": 0, **kw})
    for k, v in before.items():
        assert torch.equal(gt.params[k].raw, v), k
