"""The port's SPMD layer (``fastgaussianprocesses_torch/parallel``) on the
CPU, four gloo ranks, against the JAX package (counterpart of
``tests/test_parallel.py``).

One spawn of four ranks (``parallel.dryrun.cpu_checks``, module-scoped)
runs every check; the ranks join over a ``FileStore`` in a temporary
directory, every collective times out after 60 s, and the spawn is killed
and fails after 240 s, so that no check can hang the run.  While the ranks
work, the parent computes the JAX references (JAX meshes over 4 of the 8
virtual devices ``tests/conftest.py`` makes) and the port's unsharded runs,
from the same numpy-seeded inputs; the JAX serving references and
log-density are computed meanwhile in one more spawned process
(``_jax_refs_elsewhere``), as the JAX package's compiles hold the parent's
interpreter.

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

``comm.all_to_all`` (uneven splits, complex rows) and the residue layout
built on it (``fs.to_residues`` / ``from_residues``) are held exactly
against the gather and reshape of the same numpy arrays, the all-to-all's
gradient too.

Serving under a sequence mesh (both fast models at n = 2^12, d = 3, 64
query points; the variance also at n = 2^13, the covariance of 8 x 8
points, the credible interval, the cubature) is held at rtol 1e-10 with an
atol of 1e-12 x max|value| against the JAX package under its 4-device mesh
and against the port's unsharded model.  The noise of 1e-8 amplifies the
order of the sums, most in the lattice's coefficients ``K^-1 y`` (the
port's unsharded ones differ from the JAX package's by ~1.4e-10 of their
largest) and the quantities built on them, and the cubature variance is a
prior of 1 less a term of its size (~1.5e-8 is left, so one ulp of the
prior is 1.5e-8 of the value).  So the witness W of each quantity is the
gap between the port's unsharded value and the JAX package's under its
mesh, two implementations that differ in the order of their sums
(``_serve_witness``, bounded in ``test_serving_rounding_witness`` at 1e-9
of the largest value, the cubature variance at 8 eps of its prior).
Against the JAX package every quantity's atol is widened to 2 W, and
against the port's unsharded model so are the coefficients' and the
cubature variance's (``SERVE_WITNESSED``): the sharding moves them by as
much as the two implementations differ, and no more.

The multitask MLL under a mesh (the two-task lattice of
``tests/test_parallel.py`` at n = (2^10, 2^8), where r_0 = 4 = D and r_1 =
1, and a three-task digital net at n = (2^10, 2^9, 2^8), mt_dnb2's shape
scaled down) is held against the port's unsharded model at rtol 1e-9 (the
loss; the lattice's is ~9e-11 off, as the JAX package's unsharded loss is
from the port's: at a noise of 1e-8 the order of the sums shows there) and
rtol 1e-8 / atol 1e-10 (the gradients), its GCV and CV losses at rtol 1e-9
as the MLL (the lattice's GCV is ~1.2e-10 off), and the two-task lattice
against the JAX package under its mesh at ``tests/test_parallel.py``'s
tolerances: the loss at rtol 1e-8, the gradients at rtol 1e-4 / atol 1e-6.
The three-task net (M = 7) has no JAX reference here: the JAX package's
M = 7 solver compiles for ~60 s under a mesh on the CPU (``test_torch_multitask``
holds the port's M = 7 solver against the dense oracle).  Serving (16
points a task) is held at the serving tolerances against the same
references.

The hyperposterior of ``_hmc_model(2^8)`` under a sequence mesh: the
log-density's values and gradients for 8 chains at rtol 1e-10 against the
JAX package's vmapped log-density under its mesh; ``sample_gp_hyperposterior``
(5 warmup + 5 samples, ChEES capped at 8 leapfrog steps) against the port's
unsharded sampler on the same seed at atol 2 W, where the witness W is the
unsharded sampler's own movement when its log-density is evaluated through
the general solver instead of the half spectrum (the same sums in another
order; ~2e-10 here).  Moving y by one ulp moves no sample at all (the norm
term, ~0.5 against a log-determinant of ~-768, absorbs it), so that is no
witness.  The four ranks' samples agree bit for bit.

The two 2-D layouts, both models.  The hyperposterior on ``{"chains": 2,
"seq": 2}`` (``dryrun.seq_hmc_2d_check``, the ``SEQ_HMC`` sizes): rank (c,
s) samples 4 chains on its sequence block.  It is held against the same
mesh's sequence-only run on the same seed at rtol 1e-9 (the log-density is
row by row: the eigenvalue floor is a maximum per chain), against the
port's unsharded sampler at atol 2 W, and across the four ranks bit for
bit.  The digital net's W moves the FWHT's sums instead: its 2^8-point
Hadamard contraction as two of 2^4 (~4e-7 here, ~2e-8 of the largest
sample; the digital net's noise of 1e-16 leaves the eigenvalue floor in
charge, and the sampler amplifies a 1e-13 change of the log-density that
far in 10 iterations).  Its log-density and gradient at ``hmc_points`` are
held at rtol 1e-10 against the port's unsharded ones and, for the digital
net, against the JAX package's under its own 2 x 2 mesh; the JAX package's
2-D lattice stops in XLA's CPU FFT, so the lattice has no JAX reference
there.  The fleet step on ``{"batch": 2, "seq": 2}`` (the ``FLEET`` sizes,
the fleet sequence-sharded) is held against the JAX package's
``make_sharded_fit_step`` on its own 2 x 2 mesh at the 1-D fleet test's
rtol 1e-10 / atol 1e-12.  A ``chain_sharding`` on another mesh, and a fleet
step over the sequence axis, raise ``ValueError``.
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
SEQ_HMC = (1 << 8, 1, 5, 5, 8)  # n, seed, warmup, samples, max leapfrog steps
SERVE_WITNESSED = ("coeffs", "post_cubature_var")  # held at 2 W against the port
N_FUTURE = 1 << 13
MT_CASES = {"mt_lattice": ("FastGPLattice", (1 << 10, 1 << 8), 2),
            "mt_dnb2": ("FastGPDigitalNetB2", (1 << 10, 1 << 9, 1 << 8), 3)}
MT_JAX = ("mt_lattice",)       # the cases with a JAX reference (M <= 5)
MT_TOO_SMALL = ("FastGPLattice", (1 << 10, 2), 2)  # n_min = 2 does not split over 4 ranks
RESIDUE_RS = (4, 2, 1)         # r_v of the residue layout check, n_min = 8
TRAINED = ("scale", "lengthscales")
MESH_2D = {"chains": 2, "seq": 2}   # the hyperposterior's 2-D mesh (dryrun.seq_hmc_2d_check)
FLEET_2D = {"batch": 2, "seq": 2}   # the fleet step's (dryrun.cpu_checks)
MODELS = dryrun.FAST_MODELS
ROUNDING_CASES = (("lattice", "GCV"), ("lattice", "CV"))  # scale gradient held at W


def _inputs():
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(3, 1 << 12))
    x2 = rng.normal(size=(2, 1 << 10))
    x3 = rng.normal(size=(2, 1 << 10)) + 1j * rng.normal(size=(2, 1 << 10))
    cw = lambda s: rng.normal(size=s) + 1j * rng.normal(size=s)  # noqa: E731
    return {"fwht": (x1, rng.normal(size=x1.shape)), "fftbr": (x2, cw(x2.shape)),
            "ifftbr": (x3, cw(x3.shape))}


def _all_to_all_inputs():
    rng = np.random.default_rng(11)

    def c(k):
        return rng.normal(size=(2, k)) + 1j * rng.normal(size=(2, k))
    pieces = [[c((s + 2 * d) % 3) for d in range(WORLD)] for s in range(WORLD)]
    w = [c(sum(pieces[s][d].shape[-1] for s in range(WORLD))) for d in range(WORLD)]
    layout = ([rng.normal(size=(2, r * 8)) for r in RESIDUE_RS], RESIDUE_RS)
    return pieces, w, layout


def _query_points(d, N=64):
    return np.random.default_rng(5).uniform(size=(N, d))


def _mt_query_points():
    return {label: _query_points(case[2], 16) for label, case in MT_CASES.items()}


def _cv_weights():
    return np.random.default_rng(3).uniform(0.5, 1.5, N_SEQ)


def _jax_mesh(axes):
    """A JAX mesh over 4 of the 8 virtual devices: ``{axes: 4}`` for an axis
    name, else the axes as given (a 2-D mesh)."""
    from fastgaussianprocesses_tpu.parallel import mesh as pm
    axes = {axes: WORLD} if isinstance(axes, str) else axes
    return pm.make_mesh(axes, devices=jax.devices()[:WORLD])


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


def _jax_serve(gp, xq, n_future):
    """``dryrun.serve`` through the JAX package."""
    pm, pv = gp.post_mean_var(xq)
    ci = gp.post_ci(xq)
    out = {"coeffs": gp.coeffs, "post_mean": gp.post_mean(xq), "post_var": gp.post_var(xq),
           "post_mean_var": (pm, pv), "post_var_future": gp.post_var(xq, n=n_future),
           "post_cov": gp.post_cov(xq[:8], xq[:8]), "post_ci": (ci[3], ci[4]),
           "post_cubature_mean": gp.post_cubature_mean(),
           "post_cubature_var": gp.post_cubature_var()}
    return {k: tuple(np.asarray(t) for t in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in out.items()}


def _jax_serving():
    mesh = _jax_mesh("seq")
    xq = _query_points(D_SEQ)
    out = {}
    for name, cls_name in (("lattice", "FastGPLattice"), ("dnb2", "FastGPDigitalNetB2")):
        gp = _jax_model(cls_name, N_SEQ, D_SEQ)
        with mesh:
            gp.use_sequence_sharding(mesh)
            out[name] = _jax_serve(gp, xq, N_FUTURE)
    return out


def _gap(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))


def _largest(v):
    v = v if isinstance(v, tuple) else (v,)
    return max(float(np.abs(np.asarray(x)).max()) for x in v)


def _port_serving():
    from fastgaussianprocesses_torch.models.digital_gp import FastGPDigitalNetB2
    from fastgaussianprocesses_torch.models.lattice_gp import FastGPLattice

    return {name: dryrun.serve(dryrun._build_model(N_SEQ, D_SEQ, cls=cls, device="cpu"),
                               _query_points(D_SEQ), N_FUTURE)
            for name, cls in (("lattice", FastGPLattice), ("dnb2", FastGPDigitalNetB2))}


def _jax_multitask():
    import fastgaussianprocesses_tpu as fj

    mesh = _jax_mesh("seq")
    out = {}
    for label in MT_JAX:
        cls_name, ns, d = MT_CASES[label]
        gp = getattr(fj, cls_name)(d, num_tasks=len(ns), seed_for_seq=7)
        tasks = list(range(len(ns)))
        xs = gp.get_x_next(list(ns), task=tasks)
        gp.add_y_next([jnp.asarray(np.sin(np.asarray(x).sum(1))) for x in xs], task=tasks)
        mll_const = float(gp.n.sum()) * math.log(2 * math.pi)
        with mesh:
            gp.use_sequence_sharding(mesh)
            (loss, _), grads = gp._make_loss_fn("MLL", None, 1, mll_const, 1)(
                gp._raw_dict(), gp._fit_data())
            pm, pv = gp.post_mean_var(_mt_query_points()[label])
        out[label] = {"loss": float(loss), "grads": {k: np.asarray(v) for k, v in grads.items()},
                      "post_mean": np.asarray(pm), "post_var": np.asarray(pv)}
    return out


def _port_multitask():
    return {label: dryrun.mt_results(dryrun.mt_model(*case), _mt_query_points()[label])
            for label, case in MT_CASES.items()}


def _jax_seq_log_density(cls_name="FastGPLattice", axes="seq"):
    """The JAX package's GP log-density of ``_hmc_model`` (of ``cls_name``)
    under its mesh ``axes``, vmapped over the 8 chains of
    ``dryrun.hmc_points``: values and gradients.  On a mesh with a
    ``"chains"`` axis (the 2-D mesh) the points are placed over it."""
    import fastgaussianprocesses_tpu as fj
    from fastgaussianprocesses_tpu.fit import hmc as jh
    from jax.sharding import NamedSharding, PartitionSpec

    got = {}

    class Captured(Exception):
        pass

    def capture(logprob, init, *a, **k):
        got["logprob"], got["init"] = logprob, init
        raise Captured

    gp = getattr(fj, cls_name)(2, seed_for_seq=7)
    x = np.asarray(gp.get_x_next(SEQ_HMC[0]))
    gp.add_y_next(jnp.asarray(np.sin(2 * np.pi * x[:, 0])))
    mesh = _jax_mesh(axes)
    saved = jh.hmc
    jh.hmc = capture
    try:
        with mesh:
            gp.use_sequence_sharding(mesh)
            try:
                jh.sample_gp_hyperposterior(gp)
            except Captured:
                pass
            pts = dryrun.hmc_points({k: np.asarray(v) for k, v in got["init"].items()})
            pts = {k: jnp.asarray(p) for k, p in pts.items()}
            if "chains" in mesh.axis_names:
                pts = jax.device_put(pts, NamedSharding(mesh, PartitionSpec("chains")))
            v, g = jax.jit(jax.vmap(jax.value_and_grad(got["logprob"])))(pts)
    finally:
        jh.hmc = saved
    return np.asarray(v), {k: np.asarray(a) for k, a in g.items()}


def _port_seq_hmc():
    """For each model of ``MODELS``: the port's unsharded sampler on
    ``_hmc_model`` with the ranks' options, the same run with the same sums
    in another order -- the witness W of the module docstring -- and the
    unsharded log-density at ``dryrun.hmc_points``.  The other order: for
    the lattice the general solver (``_FastSolver``) instead of the half
    spectrum, for the digital net the FWHT's 2^8-point Hadamard contraction
    as two of 2^4 (``fwht._fwht_factors``)."""
    from fastgaussianprocesses_torch.fit.hmc import gp_log_density, sample_gp_hyperposterior
    from fastgaussianprocesses_torch.ops import fwht as tf

    n, seed, warm, samples, lmax = SEQ_HMC

    def run(gp):
        res, _ = sample_gp_hyperposterior(gp, num_samples=samples, num_warmup=warm,
                                          num_chains=8, seed=seed, max_leapfrog=lmax)
        return {k: v.numpy() for k, v in res.samples.items()}
    out = {}
    for name, cls_name in MODELS.items():
        gp = dryrun._hmc_model(n, cls_name)
        lp, sampled0 = gp_log_density(gp)
        log_density = dryrun.log_density_at(
            lp, dryrun.hmc_points({k: v.numpy() for k, v in sampled0.items()}))
        samples0 = run(gp)
        other = dryrun._hmc_model(n, cls_name)
        factors = tf._fwht_factors
        if name == "lattice":
            other._use_half_spectrum = lambda n: False
        else:
            tf._fwht_factors = lambda m: [m // 2, m - m // 2]
        try:
            samples1 = run(other)
        finally:
            tf._fwht_factors = factors
        witness = max(float(np.abs(samples0[k] - samples1[k]).max()) for k in samples0)
        out[name] = {"samples": samples0, "witness": witness, "log_density": log_density}
    return out


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


def _jax_fleet_2d(cls_name):
    """The JAX package's ``make_sharded_fit_step`` on ``dryrun.fleet_model``'s
    fleet of ``cls_name``, sequence-sharded, on its mesh ``FLEET_2D``: the
    loss and the raw parameters after one step."""
    import fastgaussianprocesses_tpu as fj
    from fastgaussianprocesses_tpu.parallel import mesh as pm

    B, n, d, seed = FLEET
    gp = getattr(fj, cls_name)(d, seed_for_seq=seed, shape_batch=(B,),
                               shape_lengthscales=(B, d), shape_scale=(B, 1))
    x = np.asarray(gp.get_x_next(n))
    gp.add_y_next(jnp.asarray(np.stack([np.sin(2 * np.pi * x[:, 0]) * (b + 1)
                                        for b in range(B)])))
    mesh = _jax_mesh(FLEET_2D)
    with mesh:
        gp.use_sequence_sharding(mesh)
        step, raw, opt_state, data = pm.make_sharded_fit_step(gp, mesh)
        loss, raw1, _ = step(raw, opt_state, data)
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


def _jax_refs_elsewhere(rank, world):
    """The spawned process's share of the JAX references (the interpreter of
    a spawned process runs the environment's start-up again, so the JAX
    platform is set to the CPU here as ``tests/conftest.py`` sets it)."""
    jax.config.update("jax_platforms", "cpu")
    return {"serve": _jax_serving(), "log_density": _jax_seq_log_density(),
            "log_density_2d": _jax_seq_log_density("FastGPDigitalNetB2", MESH_2D)}


@pytest.fixture(scope="module")
def ranks():
    inputs = _inputs()
    spec = {"transforms": inputs, "fleet": FLEET, "seq": (N_SEQ, D_SEQ, _cv_weights()),
            "hmc": HMC, "all_to_all": _all_to_all_inputs(),
            "seq_serving": (N_SEQ, D_SEQ, _query_points(D_SEQ), N_FUTURE),
            "seq_multitask": (MT_CASES, _mt_query_points(), MT_TOO_SMALL),
            "seq_hmc": SEQ_HMC}
    spawned = dryrun.SpawnedRanks(dryrun.cpu_checks, WORLD, (spec,), backend="gloo",
                                  timeout=240.0, collective_timeout=60.0)
    # no collective there to hang: the deadline only bounds JAX compiles on a loaded host
    elsewhere = dryrun.SpawnedRanks(_jax_refs_elsewhere, 1, backend="gloo", timeout=400.0)
    # five processes share the host's cores meanwhile: torch's spinning
    # threads would slow the parent's unsharded runs several-fold
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        # the port's runs first: the ranks time their collectives meanwhile
        # (``dryrun.cpu_checks`` runs the helpers first), before the JAX
        # compiles load the host
        refs = {"seq_port": _port_seq_losses(), "hmc": _port_hmc(),
                "serve_port": _port_serving(), "mt_port": _port_multitask(),
                "seq_hmc": _port_seq_hmc()}
        refs.update({"transforms": _jax_transforms(inputs), "seq": _jax_seq_losses(),
                     "fleet": _jax_fleet(), "mt": _jax_multitask(),
                     "fleet_2d": {name: _jax_fleet_2d(cls) for name, cls in MODELS.items()}})
    finally:
        torch.set_num_threads(threads)
        refs_elsewhere = elsewhere.result()[0]
        results = spawned.result()
    refs.update(refs_elsewhere)
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


def test_spawned_ranks_result_queued_before_deadline():
    """A rank's result that is already queued is returned even when the caller
    asks for it after the deadline (the fixture's parent may still be
    computing references when the ranks' deadline passes on a loaded
    host)."""
    import time

    spawned = dryrun.SpawnedRanks(max, 1, backend="gloo", timeout=60.0)
    stop = time.monotonic() + 60.0
    while spawned._queue.empty() and time.monotonic() < stop:
        time.sleep(0.05)
    spawned._deadline = time.monotonic() - 1.0
    assert spawned.result() == [1]   # max(rank 0, world 1)


def test_distributed_initialize_explicit_failure_raises():
    """A misconfigured explicit launch raises instead of running as a single
    process: a non-coordinator rank connecting to a port nothing listens on
    fails after the (shortened) 3 s timeout."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="multi-host initialize failed"):
        tdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1,
                         initialization_timeout=3)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the all-to-all and the residue layout
# ---------------------------------------------------------------------------

def test_all_to_all_matches_gather(ranks):
    """Rank d receives every rank's piece for d, in rank order (uneven and
    empty pieces, complex rows), and the gradient of ``Re sum(conj(w_d) y_d)``
    reaches each rank's input as the matching slices of every ``w_d``."""
    _, results, _ = ranks
    pieces, w, _ = _all_to_all_inputs()
    for d, r in enumerate(results):
        want = np.concatenate([pieces[s][d] for s in range(WORLD)], -1)
        np.testing.assert_array_equal(r["all_to_all"]["y"], want)
    for s, r in enumerate(results):
        grads = []
        for d in range(WORLD):
            off = sum(pieces[q][d].shape[-1] for q in range(s))
            grads.append(w[d][:, off:off + pieces[s][d].shape[-1]])
        np.testing.assert_array_equal(r["all_to_all"]["gx"], np.concatenate(grads, -1))


def test_residue_layout_matches_reshape(ranks):
    """``fs.to_residues``: rank c holds residues [c m, (c + 1) m) of every
    vector viewed as (r_v, n_min), both when r_v >= D (whole rows a rank
    before) and r_v < D (part of a row); ``from_residues`` gives the blocks
    back."""
    _, results, _ = ranks
    vecs, rs = _all_to_all_inputs()[2]
    m = 8 // WORLD
    for c, r in enumerate(results):
        for v, rv, got, back in zip(vecs, rs, r["all_to_all"]["residues"],
                                    r["all_to_all"]["roundtrip"]):
            np.testing.assert_array_equal(got, v.reshape(2, rv, 8)[..., c * m:(c + 1) * m])
            np.testing.assert_array_equal(back, np.split(v, WORLD, -1)[c])


# ---------------------------------------------------------------------------
# serving under a sequence mesh
# ---------------------------------------------------------------------------

def _assert_close(got, want, rtol=1e-10, rel_atol=1e-12, msg=""):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, v in zip(got, want):
        v = np.asarray(v)
        np.testing.assert_allclose(g, v, rtol=rtol, atol=rel_atol * float(np.abs(v).max()),
                                   err_msg=msg)


def _serve_witness(refs, model, quantity):
    """W: the gap between the port's unsharded value and the JAX package's
    under its mesh."""
    return _gap(refs["serve_port"][model][quantity], refs["serve"][model][quantity])


def _check_serving(ranks, model, quantity, ref_key):
    _, results, refs = ranks
    want = refs[ref_key][model][quantity]
    rel_atol = 1e-12
    if ref_key == "serve" or quantity in SERVE_WITNESSED:
        rel_atol = max(rel_atol, 2 * _serve_witness(refs, model, quantity) / _largest(want))
    for r in results:
        _assert_close(r["seq_serving"][model][quantity], want, rel_atol=rel_atol,
                      msg=f"{model} {quantity}")


@pytest.mark.parametrize("model", ["lattice", "dnb2"])
@pytest.mark.parametrize("quantity", dryrun.SERVE_QUANTITIES)
def test_sequence_sharded_serving_matches_jax(ranks, model, quantity):
    _check_serving(ranks, model, quantity, "serve")


@pytest.mark.parametrize("model", ["lattice", "dnb2"])
@pytest.mark.parametrize("quantity", dryrun.SERVE_QUANTITIES)
def test_sequence_sharded_serving_matches_unsharded(ranks, model, quantity):
    _check_serving(ranks, model, quantity, "serve_port")


@pytest.mark.parametrize("model", ["lattice", "dnb2"])
def test_serving_rounding_witness(ranks, model):
    """The witnesses W of every serving quantity: within 1e-9 of the largest
    value, and the cubature variance (a prior of ``scale`` = 1 less a term
    of its size) within 8 eps of the prior."""
    _, _, refs = ranks
    for q in dryrun.SERVE_QUANTITIES:
        bound = 8 * np.finfo(float).eps if q == "post_cubature_var" else \
            1e-9 * _largest(refs["serve"][model][q])
        assert _serve_witness(refs, model, q) <= bound, q


# ---------------------------------------------------------------------------
# the multitask solver under a sequence mesh
# ---------------------------------------------------------------------------

def _trained(label):
    gp = dryrun.mt_model(*MT_CASES[label])
    return [k for k, p in gp.params.items() if p.trainable]


@pytest.mark.parametrize("label", MT_JAX)
def test_sequence_sharded_multitask_mll_matches_jax(ranks, label):
    _, results, refs = ranks
    ref = refs["mt"][label]
    for r in results:
        got = r["seq_multitask"][label]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-8)
        for k in _trained(label):
            np.testing.assert_allclose(got["grads"][k], ref["grads"][k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("label", list(MT_CASES))
def test_sequence_sharded_multitask_mll_matches_unsharded(ranks, label):
    _, results, refs = ranks
    ref = refs["mt_port"][label]
    for r in results:
        got = r["seq_multitask"][label]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-9)
        for k in _trained(label):
            np.testing.assert_allclose(got["grads"][k], ref["grads"][k], rtol=1e-8, atol=1e-10,
                                       err_msg=k)


@pytest.mark.parametrize("metric", ["GCV", "CV"])
@pytest.mark.parametrize("label", list(MT_CASES))
def test_sequence_sharded_multitask_gcv_cv_match_unsharded(ranks, label, metric):
    """The GCV and CV losses: the trace of the inverse and its point-space
    diagonal (the rank's block of each task's points) under the mesh."""
    _, results, refs = ranks
    for r in results:
        np.testing.assert_allclose(r["seq_multitask"][label]["losses"][metric],
                                   refs["mt_port"][label]["losses"][metric], rtol=1e-9)


@pytest.mark.parametrize("quantity", ["post_mean", "post_var"])
@pytest.mark.parametrize("label", MT_JAX)
def test_sequence_sharded_multitask_serving_matches_jax(ranks, label, quantity):
    """At the serving tolerances, widened to 2 W as serving's (W: the port's
    unsharded value against the JAX package's under its mesh, within 1e-9
    of the largest value)."""
    _, results, refs = ranks
    want = refs["mt"][label][quantity]
    witness = _gap(refs["mt_port"][label][quantity], want)
    assert witness <= 1e-9 * _largest(want)
    for r in results:
        _assert_close(r["seq_multitask"][label][quantity], want,
                      rel_atol=max(1e-12, 2 * witness / _largest(want)),
                      msg=f"{label} {quantity}")


@pytest.mark.parametrize("quantity", ["post_mean", "post_var"])
@pytest.mark.parametrize("label", list(MT_CASES))
def test_sequence_sharded_multitask_serving_matches_unsharded(ranks, label, quantity):
    _, results, refs = ranks
    for r in results:
        _assert_close(r["seq_multitask"][label][quantity], refs["mt_port"][label][quantity],
                      msg=f"{label} {quantity}")


def test_sequence_sharded_multitask_needs_n_min_split(ranks):
    """A smallest task of n = 2 cannot split over four ranks: ``ValueError``."""
    _, results, _ = ranks
    for r in results:
        assert r["seq_multitask"]["too_small"] is not None
        assert "does not split over the 4 ranks" in r["seq_multitask"]["too_small"]


# ---------------------------------------------------------------------------
# the hyperposterior of a sequence-sharded model
# ---------------------------------------------------------------------------

def test_sequence_sharded_log_density_matches_jax(ranks):
    _, results, refs = ranks
    value, grads = refs["log_density"]
    for r in results:
        h = r["seq_hmc"]
        assert h["value"].shape == (8,)
        np.testing.assert_allclose(h["value"], value, rtol=1e-10)
        for k, g in grads.items():
            np.testing.assert_allclose(h["grads"][k], g, rtol=1e-10, err_msg=k)


def test_sequence_sharded_sampler_matches_unsharded(ranks):
    _, results, refs = ranks
    samples, witness = refs["seq_hmc"]["lattice"]["samples"], refs["seq_hmc"]["lattice"]["witness"]
    assert 0.0 < witness < 1e-8
    for r in results:
        h = r["seq_hmc"]
        assert h["log_prob"].shape == (SEQ_HMC[3], 8) and np.isfinite(h["log_prob"]).all()
        for k, v in samples.items():
            np.testing.assert_allclose(h["samples"][k], v, rtol=0, atol=2 * witness, err_msg=k)


def test_sequence_sharded_sampler_ranks_agree_bit_for_bit(ranks):
    """Every rank holds the same log-density and gradient (all-reduced), so
    the same decisions: the samples, log-densities and gradient counts are
    equal bit for bit on the four ranks."""
    _, results, _ = ranks
    h0 = results[0]["seq_hmc"]
    for r in results[1:]:
        h = r["seq_hmc"]
        assert h["grad_evals"] == h0["grad_evals"]
        np.testing.assert_array_equal(h["log_prob"], h0["log_prob"])
        for k, v in h0["samples"].items():
            np.testing.assert_array_equal(h["samples"][k], v)
        np.testing.assert_array_equal(h["value"], h0["value"])
        for k, v in h0["grads"].items():
            np.testing.assert_array_equal(h["grads"][k], v)


# ---------------------------------------------------------------------------
# the 2-D meshes: the hyperposterior over chains and sequence, the fleet step
# over batch and sequence
# ---------------------------------------------------------------------------

def _sampler_2d(results, name):
    return [r["seq_hmc_2d"][name] for r in results]


@pytest.mark.parametrize("model", list(MODELS))
def test_2d_sampler_matches_sequence_only(ranks, model):
    """Rank (c, s) samples chains [4 c, 4 c + 4) on sequence block s; the same
    mesh's sequence-only run samples all 8 on each sequence pair.  The
    log-density is row by row (the eigenvalue floor is a maximum per chain),
    so the two runs agree as the chain-sharded sampler agrees with the
    unsharded one."""
    _, results, _ = ranks
    for h in _sampler_2d(results, model):
        got, want = h["two_d"], h["seq_only"]
        assert got["log_prob"].shape == (SEQ_HMC[3], 8) and np.isfinite(got["log_prob"]).all()
        assert got["grad_evals"] == want["grad_evals"]
        np.testing.assert_allclose(got["log_prob"], want["log_prob"], rtol=1e-9)
        for k, v in want["samples"].items():
            np.testing.assert_allclose(got["samples"][k], v, rtol=1e-9, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["accept_rate"], want["accept_rate"], rtol=1e-9)
        np.testing.assert_allclose(got["step_size"], want["step_size"], rtol=1e-9)


@pytest.mark.parametrize("model", list(MODELS))
def test_2d_sampler_matches_unsharded(ranks, model):
    """Against the port's unsharded sampler on the same seed, at 2 W (the
    witness of the module docstring), W itself under 1e-7 of the largest
    sample."""
    _, results, refs = ranks
    ref = refs["seq_hmc"][model]
    largest = max(float(np.abs(v).max()) for v in ref["samples"].values())
    assert 0.0 < ref["witness"] < 1e-7 * largest
    for h in _sampler_2d(results, model):
        for k, v in ref["samples"].items():
            np.testing.assert_allclose(h["two_d"]["samples"][k], v, rtol=0,
                                       atol=2 * ref["witness"], err_msg=k)


@pytest.mark.parametrize("model", list(MODELS))
def test_2d_sampler_ranks_agree_bit_for_bit(ranks, model):
    """The four ranks return the same samples, log-densities, acceptance, step
    size and gradient count, bit for bit, and the same log-density and
    gradient at ``hmc_points`` (each rank's chain block, gathered)."""
    _, results, _ = ranks
    h0, *others = _sampler_2d(results, model)
    for h in others:
        for run in ("two_d", "seq_only"):
            a, b = h[run], h0[run]
            assert (a["grad_evals"], a["accept_rate"], a["step_size"]) == \
                (b["grad_evals"], b["accept_rate"], b["step_size"])
            np.testing.assert_array_equal(a["log_prob"], b["log_prob"])
            for k, v in b["samples"].items():
                np.testing.assert_array_equal(a["samples"][k], v)
        np.testing.assert_array_equal(h["value"], h0["value"])
        for k, v in h0["grads"].items():
            np.testing.assert_array_equal(h["grads"][k], v)


def test_2d_log_density_matches_jax(ranks):
    """The digital net's log-density and gradient at ``hmc_points`` on the
    2-D mesh, against the JAX package's vmapped log-density under its own
    ``{"chains": 2, "seq": 2}`` mesh (points placed over ``"chains"``).  The
    lattice has no JAX reference here: the JAX package's 2-D lattice stops
    in XLA's CPU FFT, so the lattice is held against the port's own runs
    (``test_2d_log_density_matches_unsharded``)."""
    _, results, refs = ranks
    value, grads = refs["log_density_2d"]
    for h in _sampler_2d(results, "dnb2"):
        assert h["value"].shape == (8,)
        np.testing.assert_allclose(h["value"], value, rtol=1e-10)
        for k, g in grads.items():
            np.testing.assert_allclose(h["grads"][k], g, rtol=1e-10, err_msg=k)


@pytest.mark.parametrize("model", list(MODELS))
def test_2d_log_density_matches_unsharded(ranks, model):
    _, results, refs = ranks
    value, grads = refs["seq_hmc"][model]["log_density"]
    for h in _sampler_2d(results, model):
        np.testing.assert_allclose(h["value"], value, rtol=1e-10)
        for k, g in grads.items():
            np.testing.assert_allclose(h["grads"][k], g, rtol=1e-10, err_msg=k)


def test_2d_chain_sharding_on_another_mesh_raises(ranks):
    """``chain_sharding`` over a 1-D chains mesh on a model sequence-sharded
    over another 1-D mesh of the same ranks: ``ValueError``."""
    _, results, _ = ranks
    for r in results:
        msg = r["seq_hmc_2d"]["mismatched"]
        assert msg is not None and "two axes of one mesh" in msg


@pytest.mark.parametrize("model", list(MODELS))
def test_2d_fleet_step_matches_jax(ranks, model):
    """``make_sharded_fit_step`` on a sequence-sharded fleet over
    ``{"batch": 2, "seq": 2}`` against the JAX package's on its own 2-D
    mesh, at the 1-D fleet test's tolerances."""
    _, results, refs = ranks
    loss_ref, raw_ref = refs["fleet_2d"][model]
    for r in results:
        got = r["fleet_2d"][model]
        np.testing.assert_allclose(got["loss"], loss_ref, rtol=1e-10)
        for k, v in raw_ref.items():
            np.testing.assert_allclose(got["raw"][k], v, atol=1e-12, err_msg=k)


def test_2d_fleet_step_over_the_sequence_axis_raises(ranks):
    _, results, _ = ranks
    for r in results:
        for got in r["fleet_2d"].values():
            assert got["same_axis"] is not None and "two axes of one mesh" in got["same_axis"]
