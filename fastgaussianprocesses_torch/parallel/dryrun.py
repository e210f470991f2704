"""The multi-device dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``), a spawner of ranks with a deadline, and the rank
bodies that the CPU tests spawn.

The bodies live in the package so that a spawned child imports nothing but
the package (and never a test module, nor with it JAX).  Each takes
``(rank, world, *args)`` in a process whose default group is initialized,
and returns numpy data.
"""

import datetime
import math
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _device() -> torch.device:
    return torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")


def _build_model(n, d, batch=None, cls=None, device=None):
    """``__graft_entry__._build_model``: a lattice model (or ``cls``) with
    y = sin(2 pi x_0) + sum(x), and per member b of a fleet (b + 1) y."""
    from ..models.lattice_gp import FastGPLattice

    cls = FastGPLattice if cls is None else cls
    kw = {}
    if batch is not None:
        kw.update(shape_batch=(batch,), shape_lengthscales=(batch, d), shape_scale=(batch, 1))
    gp = cls(d, seed_for_seq=7, alpha=2, device=device, **kw)
    x = gp.get_x_next(n).to(torch.float64)
    y = torch.sin(2 * math.pi * x[:, 0]) + x.sum(1)
    if batch is not None:
        y = torch.stack([(b + 1.0) * y for b in range(batch)])
    gp.add_y_next(y.to(gp.dtype))
    return gp


def dryrun_multichip(n_devices: int) -> dict:
    """One rank's body of the dry run over ``n_devices`` ranks (the default
    group's): the fleet's data-parallel fit step at B = n_devices, n = 64,
    d = 2 (loss, gradient and Rprop update), then the sequence-sharded MLL
    step at n = max(64, 2 n_devices), d = 2.  Raises unless both losses are
    finite; returns them."""
    from ..fit.rprop import rprop_init, rprop_update
    from .mesh import make_mesh, make_sharded_fit_step

    if dist.get_world_size() != n_devices:
        raise ValueError(f"the default group has {dist.get_world_size()} ranks, "
                         f"not {n_devices}")
    dev = _device()
    gp = _build_model(64, 2, batch=n_devices, device=dev)
    step, raw, opt_state, data = make_sharded_fit_step(gp, make_mesh({"batch": n_devices}))
    loss, raw, opt_state = step(raw, opt_state, data)
    if not math.isfinite(float(loss)):
        raise AssertionError("multichip dry run produced a non-finite loss")

    gp_sp = _build_model(max(64, 2 * n_devices), 2, device=dev)
    gp_sp.use_sequence_sharding(make_mesh({"seq": n_devices}))
    mll_const = float(gp_sp.n.sum()) * math.log(2 * math.pi)
    lag = gp_sp._make_loss_fn("MLL", None, 1, mll_const, 1)
    raw_sp = gp_sp._raw_dict()
    loss_sp, _, grads = lag(raw_sp, gp_sp._fit_data())
    trainable = {k: p.trainable for k, p in gp_sp.params.items()}
    with torch.no_grad():
        rprop_update(grads, rprop_init(raw_sp), raw_sp, trainable)
    if not math.isfinite(float(loss_sp)):
        raise AssertionError("sequence-sharded dry run produced a non-finite loss")
    return {"fleet_loss": float(loss), "seq_loss": float(loss_sp)}


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def _child(rank, world, store_path, backend, collective_timeout, call_path, out):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)  # several gloo ranks share the host's cores
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=collective_timeout), **kw)
        result = fn(rank, world, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class SpawnedRanks:
    """``world`` processes, each running ``fn(rank, world, *args)`` after
    joining a process group over a ``FileStore`` in a fresh temporary
    directory (no port to collide on).  ``backend``: "nccl" (rank r on card
    r) or "gloo" (default: "nccl" when a card is present).  Every collective
    fails after ``collective_timeout`` seconds, and :meth:`result` kills all
    the processes and raises when one fails or when ``timeout`` seconds have
    passed since the start, so that a mismatched collective cannot hang
    the caller.  A gloo rank runs torch on one intra-op thread.  ``fn`` and
    ``args`` reach the ranks through a file in the temporary directory: a
    spawned process reads its pipe only once it has imported its modules, so
    arguments too large for the pipe's buffer would hold up each start."""

    def __init__(self, fn, world, args=(), backend=None, timeout=300.0,
                 collective_timeout=60.0):
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="fgp_ranks_")
        self._queue = ctx.Queue()
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout
        self.world = world
        call_path = os.path.join(self._dir, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        self._procs = [ctx.Process(target=_child, daemon=True, args=(
            r, world, os.path.join(self._dir, "store"), backend, collective_timeout,
            call_path, self._queue)) for r in range(world)]
        for p in self._procs:
            p.start()

    def _stop(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def result(self) -> list:
        """Every rank's return value, in rank order."""
        got = {}
        try:
            while len(got) < self.world:
                left = self._deadline - time.monotonic()
                try:
                    # a result already queued counts, even when the caller
                    # asks for it after the deadline
                    rank, ok, value = self._queue.get(timeout=min(max(left, 0.0), 1.0))
                except _queue.Empty:
                    if left <= 0:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(self.world)) - set(got))} did not "
                            f"finish within {self._timeout} s") from None
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited with codes "
                                           f"{[self._procs[r].exitcode for r in dead]} "
                                           f"and no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
            for p in self._procs:
                p.join(max(1.0, self._deadline - time.monotonic()))
        finally:
            self._stop()
        return [got[r] for r in range(self.world)]


def run_ranks(fn, world, *args, **kw) -> list:
    """:class:`SpawnedRanks` run to its end."""
    return SpawnedRanks(fn, world, args, **kw).result()


# ---------------------------------------------------------------------------
# rank bodies of the CPU tests (float64, gloo)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _gather_last(x, group):
    from . import comm
    return comm.all_gather_cat(x.contiguous(), group, -1)


def transform_checks(rank, world, inputs):
    """The sharded transforms on each rank's block of ``inputs`` ({"fwht":
    (x, w), "fftbr": (x, w), "ifftbr": (x, w)}, numpy), D = world: the whole
    output (the blocks gathered) and the gradient of ``Re sum(conj(w) y)``,
    each rank backpropagating its own block's share."""
    from .mesh import make_mesh, seq_sharding_for, sharded_fftbr, sharded_fwht, sharded_ifftbr

    mesh = make_mesh({"seq": world})
    fns = {"fwht": sharded_fwht, "fftbr": sharded_fftbr, "ifftbr": sharded_ifftbr}
    group = mesh.get_group("seq")
    out = {}
    for name, (x, w) in inputs.items():
        sh = seq_sharding_for(x.ndim, mesh)
        xb = sh.block(torch.from_numpy(x)).clone().requires_grad_(True)
        y = fns[name](xb, mesh)
        loss = (sh.block(torch.from_numpy(w)).conj() * y).real.sum()
        gx, = torch.autograd.grad(loss, xb)
        out[name] = (_np(_gather_last(y.detach(), group)), _np(_gather_last(gx, group)))
        if name == "fftbr":  # the round trip through the sharded pair
            out["roundtrip"] = _np(_gather_last(sharded_ifftbr(y.detach(), mesh), group))
    return out


FAST_MODELS = {"lattice": "FastGPLattice", "dnb2": "FastGPDigitalNetB2"}


def _fast_cls(cls_name):
    from ..models.digital_gp import FastGPDigitalNetB2
    from ..models.lattice_gp import FastGPLattice
    return {"FastGPLattice": FastGPLattice, "FastGPDigitalNetB2": FastGPDigitalNetB2}[cls_name]


def fleet_model(cls_name, B, n, d, seed):
    """``tests/test_parallel.py``'s fleet: B members of ``cls_name`` over
    shared points, each with its own lengthscales and scale, member b
    observing ``(b + 1) sin(2 pi x_0)``."""
    gp = _fast_cls(cls_name)(d, seed_for_seq=seed, shape_batch=(B,), shape_lengthscales=(B, d),
                             shape_scale=(B, 1), device="cpu")
    x = gp.get_x_next(n)
    gp.add_y_next(torch.stack([torch.sin(2 * math.pi * x[:, 0]) * (b + 1) for b in range(B)]))
    return gp


def fleet_step_check(rank, world, B, n, d, seed, cls_name="FastGPLattice", axes=None):
    """One step of ``make_sharded_fit_step`` on :func:`fleet_model`: over the
    mesh ``axes`` (default ``{"batch": world}``), the fleet sequence-sharded
    over the mesh's ``"seq"`` axis where it has one (a 2-D mesh of batch and
    sequence).  The loss and the raw parameters after the step, the members'
    rows gathered; on a 2-D mesh also the message of the ``ValueError`` that
    the step over the sequence axis itself raises."""
    from . import comm
    from .mesh import make_mesh, make_sharded_fit_step

    gp = fleet_model(cls_name, B, n, d, seed)
    mesh = make_mesh(axes or {"batch": world})
    out = {}
    if "seq" in mesh.mesh_dim_names:
        gp.use_sequence_sharding(mesh, "seq")
        try:
            make_sharded_fit_step(gp, mesh, axis="seq")
            out["same_axis"] = None
        except ValueError as e:
            out["same_axis"] = str(e)
    step, raw, opt_state, data = make_sharded_fit_step(gp, mesh)
    loss, raw1, _ = step(raw, opt_state, data)
    group = mesh.get_group("batch")
    full = gp._raw_dict()
    out.update(loss=float(loss),
               raw={k: _np(comm.all_gather_cat(v, group, 0) if v.shape != full[k].shape
                           else v) for k, v in raw1.items()})
    return out


def seq_loss_checks(rank, world, n, d, cv_weights):
    """Under ``use_sequence_sharding`` over ``world`` ranks: the MLL, GCV and
    CV (per-point ``cv_weights``) losses and gradients of both fast models
    at n points in d dimensions, and the raw parameters after
    ``fit(iterations=3)`` of the lattice's MLL, with one step a dispatch and
    as the fused fit (``steps_per_dispatch=-1``)."""
    from ..models.digital_gp import FastGPDigitalNetB2
    from ..models.lattice_gp import FastGPLattice
    from .mesh import make_mesh

    mesh = make_mesh({"seq": world})
    out = {}
    for name, cls in (("lattice", FastGPLattice), ("dnb2", FastGPDigitalNetB2)):
        gp = _build_model(n, d, cls=cls, device="cpu")
        gp.use_sequence_sharding(mesh)
        mll_const = float(gp.n.sum()) * math.log(2 * math.pi)
        for metric, w in (("MLL", 1), ("GCV", 1), ("CV", cv_weights)):
            lag = gp._make_loss_fn(metric, None, 1, mll_const, w)
            loss, _, grads = lag(gp._raw_dict(), gp._fit_data())
            out[(name, metric)] = (float(loss), {k: _np(g) for k, g in grads.items()})
        if name == "lattice":
            gp.fit(iterations=3, verbose=0)
            out["fit_raw"] = {k: _np(v) for k, v in gp._raw_dict().items()}
            gp = _build_model(n, d, cls=cls, device="cpu")
            gp.use_sequence_sharding(mesh)
            out["fit_iterations_fused"] = gp.fit(iterations=3, verbose=0,
                                                 steps_per_dispatch=-1)["iterations"]
            out["fit_raw_fused"] = {k: _np(v) for k, v in gp._raw_dict().items()}
    return out


HMC_KW = dict(num_chains=8, mass_matrix="dense", trajectory_adapt="chees",
              trajectory_jitter=0.5, target_accept=0.9)


def hmc_check(rank, world, n, seed, num_warmup, num_samples):
    """Chain-sharded HMC (8 chains over ``world`` ranks, float64) on
    ``tests/test_parallel.py``'s lattice model: ``hmc`` on the GP
    log-density with ``sample_gp_hyperposterior``'s options, and
    ``sample_gp_hyperposterior`` itself (diagnostics included)."""
    from ..fit.hmc import gp_log_density, hmc, sample_gp_hyperposterior
    from .mesh import batch_sharding, make_mesh

    gp = _hmc_model(n)
    sharding = batch_sharding(make_mesh({"chains": world}), "chains")
    lp, sampled0 = gp_log_density(gp)
    res = hmc(lp, sampled0, seed, num_samples=num_samples, num_warmup=num_warmup,
              chain_sharding=sharding, **HMC_KW)
    res_gp, diag = sample_gp_hyperposterior(gp, num_samples=num_samples, num_warmup=num_warmup,
                                            num_chains=8, seed=seed, chain_sharding=sharding)
    return {"samples": {k: _np(v) for k, v in res.samples.items()},
            "log_prob": _np(res.log_prob), "accept_rate": float(res.accept_rate),
            "step_size": float(res.step_size), "gp_log_prob": _np(res_gp.log_prob),
            "gp_accept_rate": float(res_gp.accept_rate),
            "rhat": {k: v["rhat"] for k, v in diag.items()}}


def _hmc_model(n, cls_name="FastGPLattice"):
    """``tests/test_parallel.py``'s HMC model: ``cls_name`` in d = 2, seed 7,
    y = sin(2 pi x_0)."""
    gp = _fast_cls(cls_name)(2, seed_for_seq=7, device="cpu")
    x = gp.get_x_next(n)
    gp.add_y_next(torch.sin(2 * math.pi * x[:, 0]))
    return gp


def all_to_all_check(rank, world, pieces, w, layout):
    """``comm.all_to_all`` with uneven splits: rank s holds ``pieces[s]``, a
    list of (2, k) complex arrays for every rank d (k may be 0), sends them
    and backpropagates ``Re sum(conj(w[d]) y)`` on each rank d.  Returns what
    arrived and the gradient of the rank's input.  Then ``fs.to_residues``
    and ``from_residues`` on the rank's blocks of ``layout`` (a list of
    vectors, each ``r_v n_min`` long; ``rs``), the residues that arrive and
    the round trip."""
    from ..linalg import fast_solver as fs
    from . import comm
    from .mesh import make_mesh

    group = make_mesh({"seq": world}).get_group("seq")
    mine = [torch.from_numpy(p) for p in pieces[rank]]
    x = torch.cat(mine, -1).requires_grad_(True)
    outs = [pieces[s][rank].shape[-1] for s in range(world)]
    y = comm.all_to_all(x, group, [p.shape[-1] for p in mine], outs)
    gx, = torch.autograd.grad((torch.from_numpy(w[rank]).conj() * y).real.sum(), x)
    vecs, rs = layout
    blocks = [torch.from_numpy(v).tensor_split(world, -1)[rank] for v in vecs]
    res = fs.to_residues(blocks, rs, group)
    back = fs.from_residues(res, rs, group)
    return {"y": _np(y.detach()), "gx": _np(gx), "residues": [_np(r) for r in res],
            "roundtrip": [_np(b) for b in back]}


SERVE_QUANTITIES = ("coeffs", "post_mean", "post_var", "post_mean_var", "post_var_future",
                    "post_cov", "post_ci", "post_cubature_mean", "post_cubature_var")


def serve(gp, xq, n_future):
    """Every serving entry point of a fast model at the query points ``xq``
    (numpy): ``{quantity: array or tuple of arrays}`` for
    ``SERVE_QUANTITIES``; the covariance of the first 8 points with
    themselves, the variance also at ``n_future`` points, the credible
    interval's bounds."""
    x = torch.from_numpy(xq).to(gp.dtype)
    pm, pv = gp.post_mean_var(x)
    ci = gp.post_ci(x)
    out = {"coeffs": gp.coeffs, "post_mean": gp.post_mean(x), "post_var": gp.post_var(x),
           "post_mean_var": (pm, pv), "post_var_future": gp.post_var(x, n=n_future),
           "post_cov": gp.post_cov(x[:8], x[:8]), "post_ci": (ci[3], ci[4]),
           "post_cubature_mean": gp.post_cubature_mean(),
           "post_cubature_var": gp.post_cubature_var()}
    return {k: tuple(_np(t) for t in v) if isinstance(v, tuple) else _np(v)
            for k, v in out.items()}


def seq_serving_checks(rank, world, n, d, xq, n_future):
    """:func:`serve` under ``use_sequence_sharding`` over ``world`` ranks, for
    both fast models at n points in d dimensions (``_build_model``)."""
    from ..models.digital_gp import FastGPDigitalNetB2
    from ..models.lattice_gp import FastGPLattice
    from .mesh import make_mesh

    mesh = make_mesh({"seq": world})
    out = {}
    for name, cls in (("lattice", FastGPLattice), ("dnb2", FastGPDigitalNetB2)):
        gp = _build_model(n, d, cls=cls, device="cpu")
        gp.use_sequence_sharding(mesh)
        out[name] = serve(gp, xq, n_future)
    return out


def mt_model(cls_name, ns, d):
    """``tests/test_parallel.py``'s multitask model: ``cls_name`` in d
    dimensions, seed 7, one task a size in ``ns``, y = sin(sum(x))."""
    tasks = list(range(len(ns)))
    gp = _fast_cls(cls_name)(d, num_tasks=len(ns), seed_for_seq=7, device="cpu")
    xs = gp.get_x_next_host(list(ns), task=tasks)
    gp.add_y_next([torch.from_numpy(np.sin(x.sum(1))) for x in xs], task=tasks)
    return gp


def mt_results(gp, xq):
    """The MLL and its gradients, the GCV and CV losses, and
    ``post_mean_var`` at ``xq`` for every task."""
    mll_const = float(gp.n.sum()) * math.log(2 * math.pi)
    loss, _, grads = gp._make_loss_fn("MLL", None, 1, mll_const, 1)(gp._raw_dict(),
                                                                  gp._fit_data())
    others = {m: float(gp._make_loss_fn(m, None, 1, mll_const, 1)(gp._raw_dict(),
                                                                 gp._fit_data())[0])
              for m in ("GCV", "CV")}
    pm, pv = gp.post_mean_var(torch.from_numpy(xq).to(gp.dtype))
    return {"loss": float(loss), "grads": {k: _np(g) for k, g in grads.items()},
            "losses": others, "post_mean": _np(pm), "post_var": _np(pv)}


def seq_multitask_checks(rank, world, cases, xqs, too_small):
    """:func:`mt_results` of each ``cases`` entry (``{label: (cls_name, ns,
    d)}``) at its query points ``xqs[label]`` under a sequence mesh of
    ``world`` ranks, and the message of the ``ValueError`` that a model
    whose smallest task does not split over the ranks (``too_small``)
    raises (None if it raises none)."""
    from .mesh import make_mesh

    mesh = make_mesh({"seq": world})
    out = {}
    for label, case in cases.items():
        gp = mt_model(*case)
        gp.use_sequence_sharding(mesh)
        out[label] = mt_results(gp, xqs[label])
    gp = mt_model(*too_small)
    gp.use_sequence_sharding(mesh)
    try:
        mt_results(gp, np.full((1, too_small[2]), 0.5))
        out["too_small"] = None
    except ValueError as e:
        out["too_small"] = str(e)
    return out


def hmc_points(sampled0, chains=8, seed=0, spread=0.3):
    """``chains`` raw points around the start ``sampled0`` (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v)[None] + spread * rng.standard_normal((chains,) + np.shape(v))
            for k, v in sampled0.items()}


def log_density_at(lp, points):
    """A batched log-density's values and gradients at ``points`` (numpy)."""
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in points.items()}
    v = lp(leaves)
    gs = torch.autograd.grad(v.sum(), list(leaves.values()))
    return _np(v.detach()), {k: _np(g) for k, g in zip(leaves, gs)}


def seq_hmc_check(rank, world, n, seed, num_warmup, num_samples, max_leapfrog):
    """``_hmc_model(n)`` under a sequence mesh of ``world`` ranks:
    ``gp_log_density``'s values and gradients for 8 chains at
    :func:`hmc_points` and ``sample_gp_hyperposterior`` (8 chains, ChEES at
    most ``max_leapfrog`` steps)."""
    from ..fit.hmc import gp_log_density, sample_gp_hyperposterior
    from .mesh import make_mesh

    gp = _hmc_model(n)
    gp.use_sequence_sharding(make_mesh({"seq": world}))
    lp, sampled0 = gp_log_density(gp)
    value, grads = log_density_at(lp, hmc_points({k: _np(v) for k, v in sampled0.items()}))
    res, _ = sample_gp_hyperposterior(gp, num_samples=num_samples, num_warmup=num_warmup,
                                      num_chains=8, seed=seed, max_leapfrog=max_leapfrog)
    return {"value": value, "grads": grads, "log_prob": _np(res.log_prob),
            "samples": {k: _np(v) for k, v in res.samples.items()},
            "grad_evals": res.num_grad_evals}


def _sampled(res):
    return {"samples": {k: _np(v) for k, v in res.samples.items()},
            "log_prob": _np(res.log_prob), "accept_rate": float(res.accept_rate),
            "step_size": float(res.step_size), "grad_evals": res.num_grad_evals}


def seq_hmc_2d_check(rank, world, n, seed, num_warmup, num_samples, max_leapfrog):
    """The hyperposterior on the 2-D mesh ``{"chains": 2, "seq": world //
    2}``, for both models of :data:`FAST_MODELS` (``_hmc_model(n, cls)``
    sequence-sharded over ``"seq"``): ``gp_log_density``'s values and
    gradients at :func:`hmc_points`, each rank evaluating its chain block's
    rows, gathered over the chains group; ``sample_gp_hyperposterior``
    with ``chain_sharding`` on the ``"chains"`` axis (8 chains, ChEES at
    most ``max_leapfrog`` steps) and, on the same seed, the same mesh's
    sequence-only run (all 8 chains on each sequence group).  Then the
    message of the ``ValueError`` that ``chain_sharding`` on another mesh
    raises (two 1-D meshes over the same ranks)."""
    from ..fit.hmc import gp_log_density, sample_gp_hyperposterior
    from . import comm
    from .mesh import batch_sharding, make_mesh

    mesh = make_mesh({"chains": 2, "seq": world // 2})
    sharding = batch_sharding(mesh, "chains")
    kw = dict(num_samples=num_samples, num_warmup=num_warmup, num_chains=8, seed=seed,
              max_leapfrog=max_leapfrog)
    out = {}
    for name, cls_name in FAST_MODELS.items():
        gp = _hmc_model(n, cls_name)
        gp.use_sequence_sharding(mesh, "seq")
        lp, sampled0 = gp_log_density(gp)
        pts = hmc_points({k: _np(v) for k, v in sampled0.items()})
        value, grads = log_density_at(lp, {k: _np(sharding.block(torch.from_numpy(v)))
                                           for k, v in pts.items()})
        every = {k: _np(comm.all_gather_cat(torch.from_numpy(v), sharding.group, 0))
                 for k, v in (("value", value), *grads.items())}
        out[name] = {"value": every.pop("value"), "grads": every}
        res2, _ = sample_gp_hyperposterior(gp, chain_sharding=sharding, **kw)
        res1, _ = sample_gp_hyperposterior(gp, **kw)
        out[name].update(two_d=_sampled(res2), seq_only=_sampled(res1))
    gp = _hmc_model(n)
    gp.use_sequence_sharding(make_mesh({"seq": world}))
    try:
        sample_gp_hyperposterior(gp, num_samples=1, num_warmup=1, num_chains=8, seed=seed,
                                 chain_sharding=batch_sharding(make_mesh({"chains": world}),
                                                               "chains"))
        out["mismatched"] = None
    except ValueError as e:
        out["mismatched"] = str(e)
    return out


def helper_checks(rank, world):
    """``parallel.distributed`` in a group of ``world`` gloo ranks: the
    argument-free ``initialize`` (a no-op once joined), ``global_mesh``,
    ``process_local_batch``, the collective latency at 1 and ``world``
    ranks, ``measure_hmc_scaling`` (tiny), and ``dryrun_multichip``."""
    from . import distributed as D

    D.initialize()
    mesh = D.global_mesh({"batch": -1})
    coll = D.measure_collective_overhead(num_chains=8, device_counts=(1, world), steps=200)
    scaling = D.measure_hmc_scaling(_hmc_model(64), num_chains=8, device_counts=(1, world),
                                    num_samples=2, num_warmup=2)
    return {"mesh_size": int(np.prod(mesh.shape)), "local_batch": D.process_local_batch(16),
            "collective": coll, "scaling": scaling, "dryrun": dryrun_multichip(world)}


def cpu_checks(rank, world, spec):
    """Every rank body above in one process group (``tests/test_torch_parallel``
    spawns it once): ``spec`` holds the transforms' inputs and the sizes.
    The helpers come first: their collective latency is timed before the
    parent's JAX references load the host most."""
    helpers = helper_checks(rank, world)
    out = {"transforms": transform_checks(rank, world, spec["transforms"]),
           "fleet": fleet_step_check(rank, world, *spec["fleet"]),
           "seq": seq_loss_checks(rank, world, *spec["seq"]),
           "hmc": hmc_check(rank, world, *spec["hmc"]),
           "all_to_all": all_to_all_check(rank, world, *spec["all_to_all"]),
           "seq_serving": seq_serving_checks(rank, world, *spec["seq_serving"]),
           "seq_multitask": seq_multitask_checks(rank, world, *spec["seq_multitask"]),
           "seq_hmc": seq_hmc_check(rank, world, *spec["seq_hmc"]),
           "seq_hmc_2d": seq_hmc_2d_check(rank, world, *spec["seq_hmc"]),
           "fleet_2d": {name: fleet_step_check(rank, world, *spec["fleet"], cls_name,
                                               {"batch": 2, "seq": world // 2})
                        for name, cls_name in FAST_MODELS.items()},
           "helpers": helpers}
    return out
