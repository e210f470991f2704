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

def _child(rank, world, store_path, backend, collective_timeout, fn, args, out):
    try:
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
    the caller.  A gloo rank runs torch on one intra-op thread."""

    def __init__(self, fn, world, args=(), backend=None, timeout=300.0,
                 collective_timeout=60.0):
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="fgp_ranks_")
        self._queue = ctx.Queue()
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout
        self.world = world
        self._procs = [ctx.Process(target=_child, daemon=True, args=(
            r, world, os.path.join(self._dir, "store"), backend, collective_timeout,
            fn, args, self._queue)) for r in range(world)]
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
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(self.world)) - set(got))} "
                                       f"did not finish within {self._timeout} s")
                try:
                    rank, ok, value = self._queue.get(timeout=min(left, 1.0))
                except _queue.Empty:
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


def fleet_step_check(rank, world, B, n, d, seed):
    """One step of ``make_sharded_fit_step`` on a lattice fleet of B members
    (``tests/test_parallel.py``'s): the loss and the raw parameters after the
    step, the members' rows gathered."""
    from ..models.lattice_gp import FastGPLattice
    from . import comm
    from .mesh import make_mesh, make_sharded_fit_step

    gp = FastGPLattice(d, seed_for_seq=seed, shape_batch=(B,), shape_lengthscales=(B, d),
                       shape_scale=(B, 1), device="cpu")
    x = gp.get_x_next(n)
    gp.add_y_next(torch.stack([torch.sin(2 * math.pi * x[:, 0]) * (b + 1) for b in range(B)]))
    mesh = make_mesh({"batch": world})
    step, raw, opt_state, data = make_sharded_fit_step(gp, mesh)
    loss, raw1, _ = step(raw, opt_state, data)
    group = mesh.get_group("batch")
    full = gp._raw_dict()
    return {"loss": float(loss),
            "raw": {k: _np(comm.all_gather_cat(v, group, 0) if v.shape != full[k].shape
                           else v) for k, v in raw1.items()}}


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


def _hmc_model(n):
    from ..models.lattice_gp import FastGPLattice
    gp = FastGPLattice(2, seed_for_seq=7, device="cpu")
    x = gp.get_x_next(n)
    gp.add_y_next(torch.sin(2 * math.pi * x[:, 0]))
    return gp


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
    spawns it once): ``spec`` holds the transforms' inputs and the sizes."""
    out = {"transforms": transform_checks(rank, world, spec["transforms"]),
           "fleet": fleet_step_check(rank, world, *spec["fleet"]),
           "seq": seq_loss_checks(rank, world, *spec["seq"]),
           "hmc": hmc_check(rank, world, *spec["hmc"]),
           "helpers": helper_checks(rank, world)}
    return out
