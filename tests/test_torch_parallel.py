"""The port's SPMD layer (``fastgaussianprocesses_torch/parallel``) on the
CPU, four gloo ranks, against the JAX package (counterpart of
``tests/test_parallel.py``).

One spawn of four ranks (``parallel.dryrun.cpu_checks``, module-scoped)
runs every check; the ranks join over a ``FileStore`` in a temporary
directory, every collective times out after 60 s, and the spawn is killed
and fails after 240 s, so that no check can hang the run.  While the ranks
work, the parent computes the JAX references (JAX meshes over 4 of the 8
virtual devices ``tests/conftest.py`` makes) and the port's unsharded runs,
from the same numpy-seeded inputs.

Tolerances: the sharded transforms sum in another order than the
unsharded ones (the cross-shard factor is a reduce-scatter), so they are
held at atol 1e-10, as ``tests/test_parallel.py`` holds the JAX package's.
The sequence-sharded losses are held at rtol 1e-10 and their gradients at
rtol 1e-8 / atol 1e-10, against the JAX package and against the port's
unsharded model, with one exception: the lattice's scale gradient under GCV
and CV (``ROUNDING_CASES``).  Those losses (~64 here) see the scale only
through the noise, so that gradient (~3.3e-4) is what is left of terms the
size of the loss, and a change in the order of the spectrum's sums moves it
by ~1e-9.  It is held at the witness ``W``: the largest gap between the
port's UNSHARDED scale gradient and the JAX package's over those two cases
(two unsharded implementations that differ only in the order of their sums;
~6e-9 on the CV case, ~7e-10 on GCV), which must itself stay under 1e-10 of
the loss (``test_scale_gradient_rounding_witness``).  The digital net's
scale gradients under GCV and CV pass at atol 1e-10 and take no exception.
The chain-sharded sampler is held against the port's unsharded sampler on
the same seed at 1e-9 (float64, 10 iterations; see ``_port_hmc``).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastgaussianprocesses_torch.parallel import distributed as tdist
from fastgaussianprocesses_torch.parallel import dryrun

WORLD = 4
N_SEQ, D_SEQ = 1 << 12, 3
FLEET = (8, 64, 2, 3)          # B, n, d, seed_for_seq
HMC = (64, 1, 5, 5)            # n, seed, warmup, samples
TRAINED = ("scale", "lengthscales")
ROUNDING_CASES = (("lattice", "GCV"), ("lattice", "CV"))  # scale gradient held at W


def _inputs():
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(3, 1 << 12))
    x2 = rng.normal(size=(2, 1 << 10))
    x3 = rng.normal(size=(2, 1 << 10)) + 1j * rng.normal(size=(2, 1 << 10))
    cw = lambda s: rng.normal(size=s) + 1j * rng.normal(size=s)  # noqa: E731
    return {"fwht": (x1, rng.normal(size=x1.shape)), "fftbr": (x2, cw(x2.shape)),
            "ifftbr": (x3, cw(x3.shape))}


def _cv_weights():
    return np.random.default_rng(3).uniform(0.5, 1.5, N_SEQ)


def _jax_mesh(axis):
    from fastgaussianprocesses_tpu.parallel import mesh as pm
    return pm.make_mesh({axis: WORLD}, devices=jax.devices()[:WORLD])


def _jax_transforms(inputs):
    from fastgaussianprocesses_tpu.ops import transforms as tr
    from fastgaussianprocesses_tpu.parallel import mesh as pm

    mesh = _jax_mesh("seq")
    out = {}
    for name, ref, sharded in (("fwht", tr.fwht, pm.sharded_fwht),
                               ("fftbr", tr.fftbr, pm.sharded_fftbr),
                               ("ifftbr", tr.ifftbr, pm.sharded_ifftbr)):
        x = jnp.asarray(inputs[name][0])
        with mesh:
            got = jax.jit(lambda v, f=sharded: f(v, mesh))(x)
        out[name] = (np.asarray(ref(x)), np.asarray(got))
    return out


def _jax_model(cls_name, n, d):
    import fastgaussianprocesses_tpu as fj
    gp = getattr(fj, cls_name)(d, seed_for_seq=7, alpha=2)
    x = np.asarray(gp.get_x_next(n))
    gp.add_y_next(jnp.asarray(np.sin(2 * np.pi * x[:, 0]) + x.sum(1)))
    return gp


def _jax_seq_losses():
    out = {}
    for name, cls_name in (("lattice", "FastGPLattice"), ("dnb2", "FastGPDigitalNetB2")):
        gp = _jax_model(cls_name, N_SEQ, D_SEQ)
        mll_const = float(gp.n.sum()) * math.log(2 * math.pi)
        for metric, w in (("MLL", 1), ("GCV", 1), ("CV", jnp.asarray(_cv_weights()))):
            (loss, _), grads = gp._make_loss_fn(metric, None, 1, mll_const, w)(
                gp._raw_dict(), gp._fit_data())
            out[(name, metric)] = (float(loss), {k: np.asarray(grads[k]) for k in TRAINED})
    return out


def _port_seq_losses():
    """The port's unsharded losses and gradients on the ranks' models."""
    from fastgaussianprocesses_torch.models.digital_gp import FastGPDigitalNetB2
    from fastgaussianprocesses_torch.models.lattice_gp import FastGPLattice

    out = {}
    for name, cls in (("lattice", FastGPLattice), ("dnb2", FastGPDigitalNetB2)):
        gp = dryrun._build_model(N_SEQ, D_SEQ, cls=cls, device="cpu")
        mll_const = float(gp.n.sum()) * math.log(2 * math.pi)
        for metric, w in (("MLL", 1), ("GCV", 1), ("CV", _cv_weights())):
            loss, _, grads = gp._make_loss_fn(metric, None, 1, mll_const, w)(
                gp._raw_dict(), gp._fit_data())
            out[(name, metric)] = (float(loss), {k: grads[k].numpy() for k in TRAINED})
    return out


def _witness(refs):
    """W: the largest gap between the port's unsharded scale gradient and the
    JAX package's over ``ROUNDING_CASES``."""
    return max(float(np.abs(refs["seq_port"][c][1]["scale"] - refs["seq"][c][1]["scale"]).max())
               for c in ROUNDING_CASES)


def _jax_fleet():
    from fastgaussianprocesses_tpu import FastGPLattice
    from fastgaussianprocesses_tpu.fit.rprop import rprop_init, rprop_update

    B, n, d, seed = FLEET
    gp = FastGPLattice(d, seed_for_seq=seed, shape_batch=(B,), shape_lengthscales=(B, d),
                       shape_scale=(B, 1))
    x = np.asarray(gp.get_x_next(n))
    gp.add_y_next(jnp.asarray(np.stack([np.sin(2 * np.pi * x[:, 0]) * (b + 1)
                                        for b in range(B)])))
    mll_const = B * float(gp.n.sum()) * math.log(2 * math.pi)
    raw0 = gp._raw_dict()
    (loss, _), grads = gp._make_loss_fn("MLL", None, B, mll_const, 1)(raw0, gp._fit_data())
    raw1, _ = rprop_update(grads, rprop_init(raw0), raw0,
                           {k: p.trainable for k, p in gp.params.items()})
    return float(loss), {k: np.asarray(v) for k, v in raw1.items()}


def _port_hmc():
    """The unsharded sampler on the same seed, its log-density evaluated in
    the ranks' blocks of 2 chains: the GP log-density's gradient depends on
    the number of rows it is given at ~5e-13 (float64, CPU FFTs), and the
    sampler amplifies that to ~1e-6 in 10 iterations; evaluated the same
    way, the sharded run must equal this one."""
    from fastgaussianprocesses_torch.fit.hmc import gp_log_density, hmc

    n, seed, warm, samples = HMC
    lp, sampled0 = gp_log_density(dryrun._hmc_model(n))
    per = 8 // WORLD

    def blocked(s):
        return torch.cat([lp({k: v[per * r:per * (r + 1)] for k, v in s.items()})
                          for r in range(WORLD)])

    return hmc(blocked, sampled0, seed, num_samples=samples, num_warmup=warm, **dryrun.HMC_KW)


@pytest.fixture(scope="module")
def ranks():
    inputs = _inputs()
    spec = {"transforms": inputs, "fleet": FLEET, "seq": (N_SEQ, D_SEQ, _cv_weights()),
            "hmc": HMC}
    spawned = dryrun.SpawnedRanks(dryrun.cpu_checks, WORLD, (spec,), backend="gloo",
                                  timeout=240.0, collective_timeout=60.0)
    try:
        refs = {"transforms": _jax_transforms(inputs), "seq": _jax_seq_losses(),
                "seq_port": _port_seq_losses(), "fleet": _jax_fleet(), "hmc": _port_hmc()}
    finally:
        results = spawned.result()
    return inputs, results, refs


@pytest.mark.parametrize("name", ["fwht", "fftbr", "ifftbr"])
def test_sharded_transform_matches_jax(ranks, name):
    _, results, refs = ranks
    want, want_sharded = refs["transforms"][name]
    for r in results:
        got = r["transforms"][name][0]
        np.testing.assert_allclose(got, want, atol=1e-10)
        np.testing.assert_allclose(got, want_sharded, atol=1e-10)


@pytest.mark.parametrize("name", ["fwht", "fftbr", "ifftbr"])
def test_sharded_transform_gradient_matches_unsharded(ranks, name):
    """Each rank backpropagates its block's share of Re sum(conj(w) y) through
    the reduce-scatter; the gathered gradient equals autograd through the
    unsharded transform of the port."""
    from fastgaussianprocesses_torch.ops import fwht as tf, transforms as ttr

    inputs, results, _ = ranks
    x, w = inputs[name]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = {"fwht": tf.fwht, "fftbr": ttr.fftbr, "ifftbr": ttr.ifftbr}[name](xt)
    g, = torch.autograd.grad((torch.from_numpy(w).conj() * y).real.sum(), xt)
    for r in results:
        np.testing.assert_allclose(r["transforms"][name][1], g.numpy(), atol=1e-10)


def test_sharded_fft_roundtrip(ranks):
    inputs, results, _ = ranks
    np.testing.assert_allclose(results[0]["transforms"]["roundtrip"],
                               inputs["fftbr"][0], atol=1e-10)


def test_sharded_fleet_fit_step_matches_jax(ranks):
    _, results, refs = ranks
    loss_ref, raw_ref = refs["fleet"]
    for r in results:
        np.testing.assert_allclose(r["fleet"]["loss"], loss_ref, rtol=1e-10)
        for k, v in raw_ref.items():
            np.testing.assert_allclose(r["fleet"]["raw"][k], v, atol=1e-12, err_msg=k)


def _check_seq_loss(ranks, model, metric, ref_key):
    _, results, refs = ranks
    loss_ref, grads_ref = refs[ref_key][(model, metric)]
    for r in results:
        loss, grads = r["seq"][(model, metric)]
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-10)
        for k in TRAINED:
            # see the module docstring: the scale gradient there is held at W
            atol = _witness(refs) if (k == "scale" and (model, metric) in ROUNDING_CASES) \
                else 1e-10
            np.testing.assert_allclose(grads[k], grads_ref[k], rtol=1e-8, atol=atol,
                                       err_msg=f"{model} {metric} {k}")


@pytest.mark.parametrize("model", ["lattice", "dnb2"])
@pytest.mark.parametrize("metric", ["MLL", "GCV", "CV"])
def test_sequence_sharded_loss_matches_jax(ranks, model, metric):
    _check_seq_loss(ranks, model, metric, "seq")


@pytest.mark.parametrize("model", ["lattice", "dnb2"])
@pytest.mark.parametrize("metric", ["MLL", "GCV", "CV"])
def test_sequence_sharded_loss_matches_unsharded(ranks, model, metric):
    """The sharding's own error (the reduce-scatter, the 1/D seed, the
    group sums) against the port's unsharded model on the same data."""
    _check_seq_loss(ranks, model, metric, "seq_port")


@pytest.mark.parametrize("metric", ["GCV", "CV"])
def test_scale_gradient_rounding_witness(ranks, metric):
    """The witness W behind ``ROUNDING_CASES``: the port's unsharded lattice
    matches the JAX package's loss at rtol 1e-10, and its scale gradient
    differs from the JAX package's by no more than 1e-10 of the loss, though
    both are unsharded: that gap is the order of the sums alone."""
    _, _, refs = ranks
    loss_jax, grads_jax = refs["seq"][("lattice", metric)]
    loss, grads = refs["seq_port"][("lattice", metric)]
    np.testing.assert_allclose(loss, loss_jax, rtol=1e-10)
    np.testing.assert_allclose(grads["scale"], grads_jax["scale"], rtol=0,
                               atol=1e-10 * abs(loss_jax))
    assert _witness(refs) <= 1e-10 * abs(loss_jax)


def test_sequence_sharded_fit_matches_unsharded(ranks):
    """``fit(iterations=3)`` under the mesh: Rprop sees the same gradients on
    every rank, and its steps are the unsharded fit's."""
    _, results, _ = ranks
    gp = dryrun._build_model(N_SEQ, D_SEQ, device="cpu")
    gp.fit(iterations=3, verbose=0)
    for r in results:
        for k, v in gp._raw_dict().items():
            np.testing.assert_allclose(r["seq"]["fit_raw"][k], v.numpy(), atol=1e-12,
                                       err_msg=k)


def test_sequence_sharded_fused_fit_matches_unsharded(ranks):
    """``fit(iterations=3, steps_per_dispatch=-1)`` under the mesh: every
    rank computes the same global loss, so the same stop flag, and lands on
    the unsharded fused fit's iteration and parameters."""
    _, results, _ = ranks
    gp = dryrun._build_model(N_SEQ, D_SEQ, device="cpu")
    its = gp.fit(iterations=3, verbose=0, steps_per_dispatch=-1)["iterations"]
    for r in results:
        assert r["seq"]["fit_iterations_fused"] == its
        for k, v in gp._raw_dict().items():
            np.testing.assert_allclose(r["seq"]["fit_raw_fused"][k], v.numpy(), atol=1e-12,
                                       err_msg=k)


def test_chain_sharded_hmc_matches_unsharded(ranks):
    _, results, refs = ranks
    ref = refs["hmc"]
    for r in results:
        h = r["hmc"]
        for lp, acc in ((h["log_prob"], h["accept_rate"]),
                        (h["gp_log_prob"], h["gp_accept_rate"])):
            assert lp.shape == (HMC[3], 8) and np.isfinite(lp).all()
            assert 0.0 < acc <= 1.0
        np.testing.assert_allclose(h["log_prob"], ref.log_prob.numpy(), rtol=1e-9)
        for k, v in ref.samples.items():
            np.testing.assert_allclose(h["samples"][k], v.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(h["accept_rate"], float(ref.accept_rate), rtol=1e-9)
        np.testing.assert_allclose(h["step_size"], float(ref.step_size), rtol=1e-9)


def test_collective_latency_and_hmc_scaling(ranks):
    """The HMC step's only cross-chain traffic is a scalar all-reduce a step:
    at 4 gloo ranks it must stay under 5e-3 s a step (as in
    ``tests/test_parallel.py``), and the scaling measurement must run."""
    _, results, _ = ranks
    h = results[0]["helpers"]
    assert h["collective"]["latency_s"][str(WORLD)] < 5e-3, h["collective"]
    sps = h["scaling"]["samples_per_s"]
    assert set(sps) == {1, WORLD} and all(v > 0 and np.isfinite(v) for v in sps.values())
    assert all(r["helpers"]["collective"] == h["collective"] for r in results)


def test_distributed_helpers(ranks):
    _, results, _ = ranks
    for rank, r in enumerate(results):
        h = r["helpers"]
        assert h["mesh_size"] == WORLD
        assert h["local_batch"] == slice(4 * rank, 4 * rank + 4)
    # single process: the argument-free initialize is a no-op, one process owns all
    tdist.initialize()
    assert tdist.process_local_batch(16) == slice(0, 16)
    np.testing.assert_allclose(tdist.hmc_scaling_efficiency({1: 100.0, 8: 750.0}),
                               750.0 / 8 / 100.0)


def test_dryrun_multichip(ranks):
    _, results, _ = ranks
    for r in results:
        d = r["helpers"]["dryrun"]
        assert np.isfinite(d["fleet_loss"]) and np.isfinite(d["seq_loss"])


def test_distributed_initialize_explicit_failure_raises():
    """A misconfigured explicit launch raises instead of running as a single
    process: a non-coordinator rank connecting to a port nothing listens on
    fails after the (shortened) 3 s timeout."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="multi-host initialize failed"):
        tdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1,
                         initialization_timeout=3)
    assert not dist.is_initialized()
