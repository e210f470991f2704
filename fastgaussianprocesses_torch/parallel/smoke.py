"""The rank body of ``chip_smoke.py``'s parallel phase: phase 8 of the default
run (one card, a process group of one, made in the process itself) and the
``--multichip`` mode (one process a card, spawned by
``dryrun.SpawnedRanks``).  It lives in the package so that a spawned rank
imports nothing else.

:func:`body` runs, on every rank of the default group (D ranks):

* ``fleet``: ``make_sharded_fit_step`` on the fleet configuration
  (``FastGPLattice`` and ``FastGPDigitalNetB2``, d = 8, 8 members with
  their own lengthscales and scale, n = 2^16): its loss and raw parameters
  against the same model's one-card step on rank 0, the kernels launched
  every step on B / D rows (K1 and, as its backward, K2; or K4 twice), the
  step's wall time (chains of 16 steps, best of 3) beside the one-card
  step's, and a profile of it (device busy share, launches a step); with
  ``full`` on four or more ranks the same on the 2-D mesh ``{"batch": 2,
  "seq": D / 2}``, the fleet sequence-sharded (K4 at least twice a step on
  the digital net's (B / 2, n / (D / 2)) blocks), against the one-card
  step;
* ``seq``: ``use_sequence_sharding`` on ``bench.py``'s flagship (d = 8,
  seed 7, alpha 2, n = 2^20, float32): the loss and gradient of each
  metric against the one-card model's, K4 launched for the digital net,
  the step's wall time; with ``full``, both models, MLL, GCV and CV, and
  the same at n = 2^16 in float64, the sharded transforms at n = 2^20
  against the one-card ones, and the peak memory of a rank's MLL step at
  n = 2^20 and 2^22 beside one card's;
* ``hmc``: chain-sharded ``sample_gp_hyperposterior`` of ``hmc_lattice``
  (d = 4, n = 2^14, ``fit(iterations=30)`` first, 8 chains) and, with
  ``full``, ``hmc_flagship`` (d = 8, n = 2^20, at most 32 leapfrog
  steps): the first iteration against the one-card sampler on the same
  seed, every gradient one K1 and one K2 launch on C / D rows, every
  log-density finite; then the acceptance and step size of a whole run
  beside the one-card run's (dual averaging amplifies the reduction
  order, so later draws are compared as distributions);
* ``collective``: ``measure_collective_overhead`` at 1 and D ranks; with
  ``full``, ``measure_hmc_scaling`` of both HMC configurations and
  ``dryrun_multichip(D)``;
* with ``full``, the three paths that run under a sequence mesh, each
  against rank 0's one-card run of the same model:
  ``seq_serving``, both flagships (n = 2^20, d = 8): ``post_mean_var`` of
  ``n_query`` points, ``coeffs`` and the cubature mean and variance, a
  steady request timed (best of 2) on D cards and on one, profiled on rank 0,
  and a rank's peak memory; ``seq_multitask``, mt_dnb2 (3 tasks at n =
  (2^20, 2^19, 2^18), M = 7): the MLL and its gradient (timed on D cards
  and one, the all-to-alls a step counted) and ``post_mean_var`` of
  ``n_query_mt`` points a task; ``seq_hmc``, ``hmc_flagship``'s
  configuration (lattice, d = 8, n = 2^20) and the digital net at that
  size, sequence-sharded: the log-density and gradient of 8 chains at the
  start, a whole run's samples/s, acceptance and step size on D cards and
  one, and every rank's samples equal bit for bit; then the same on the 2-D
  mesh ``{"chains": 2, "seq": D / 2}`` (``chain_sharding`` over
  ``"chains"``; the digital net launches K4 at least twice a gradient, on
  (C / 2, n / (D / 2)) blocks), against the same one-card reference.  K4's
  launches and the (n, rows) of each are recorded on every path that runs
  it.

Rank 0 computes every one-card reference on its own card while the other
ranks wait at their next collective.  Any disagreement raises.  On the CPU
(gloo) the same body runs at the sizes ``cfg`` gives, without the launch
checks.
"""

import math
import time

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .mesh import axis_size, batch_sharding, make_mesh, make_sharded_fit_step

D_MAIN = 8
C_HMC = 8


def _f(x):
    """``bench.py``'s function."""
    return np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _cls(name):
    from .. import FastGPDigitalNetB2, FastGPLattice
    return {"lattice": FastGPLattice, "dnb2": FastGPDigitalNetB2}[name]


def _model(name, n, d, dtype, device):
    """``bench.py``'s fit configuration: d dimensions, seed 7, alpha 2."""
    gp = _cls(name)(d, seed_for_seq=7, alpha=2, dtype=dtype, device=device)
    gp.add_y_next(torch.as_tensor(_f(gp.get_x_next_host(n))))
    return gp


def _fleet(name, n, dtype, device):
    """``chip_smoke.fleet_model``: 8 members over shared points with their
    own lengthscales (from seed 7) and scale, member b observing (b + 1) f,
    the noise at 1e-8."""
    d, B = D_MAIN, 8
    gp = _cls(name)(d, seed_for_seq=7, alpha=2, shape_batch=(B,), shape_lengthscales=(B, d),
                    shape_scale=(B, 1), dtype=dtype, device=device)
    y = _f(gp.get_x_next_host(n))
    gp.add_y_next(torch.as_tensor(np.stack([(b + 1) * y for b in range(B)])))
    raw = {k: p.raw.clone() for k, p in gp.params.items()}
    rng = np.random.default_rng(7)
    raw["lengthscales"] = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, d)), dtype=gp.dtype,
                                          device=gp.device)
    raw["noise"] = torch.full_like(raw["noise"], math.log(1e-8))
    gp._set_raw(raw)
    return gp


class _Kernels:
    """The launch counters of K1-K4, the plain versions of K1, K2 and K4
    made to raise (on the card), the rows of every launch and the launches
    at each (n, rows)."""

    def __init__(self, on_card):
        from ..ops import fwht as tf, perm_fft as tp
        self.tp, self.tf, self.on_card = tp, tf, on_card
        self.rows = {}
        self.shapes = {}

    def __enter__(self):
        self.saved = []
        if not self.on_card:
            return self

        def refuse(*a, **k):
            raise AssertionError("the card path reached a plain kernel version")
        for m, k in ((self.tp, "pfft_plain"), (self.tp, "pifft_real_plain"),
                     (self.tf, "fwht_plain")):
            self.saved.append((m, k, getattr(m, k)))
            setattr(m, k, refuse)
        for m, k, name in ((self.tp, "_pfft_cuda", "pfft"),
                           (self.tp, "_pifft_real_cuda", "pifft_real"),
                           (self.tf, "_fwht_cuda", "fwht")):
            f = getattr(m, k)
            self.saved.append((m, k, f))

            def spy(x, *a, _f=f, _name=name, **kw):
                rows = x.numel() // x.shape[-1]
                self.rows.setdefault(_name, set()).add(rows)
                shapes = self.shapes.setdefault(_name, {})
                shapes[(x.shape[-1], rows)] = shapes.get((x.shape[-1], rows), 0) + 1
                return _f(x, *a, **kw)
            setattr(m, k, spy)
        return self

    def __exit__(self, *exc):
        for m, k, f in self.saved:
            setattr(m, k, f)

    def reset(self):
        self.tp.reset_launches()
        self.tf.reset_launches()
        self.rows = {}
        self.shapes = {}

    def k4_shapes(self):
        """K4's launches since the reset as sorted ``[n, rows, launches]``."""
        return sorted([n, r, c] for (n, r), c in self.shapes.get("fwht", {}).items())

    def counts(self):
        return {**self.tp.launches, **self.tf.launches}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _best_ms(fn, steps, dev):
    """Wall ms a step of ``fn`` run ``steps`` times back to back, ended by a
    device sync; best of 3 after a warm chain."""
    fn()
    _sync(dev)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / steps * 1e3)
    return best


def _dev_us(e):
    """Device time of a profiler event of a CUDA kernel (the attribute's name
    varies by release), 0 for anything else."""
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
        return 0.0
    return float(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))


def _profile(fn, steps, wall_ms):
    """Device ms and kernel launches a step under ``torch.profiler`` (CUDA
    activity only), and the device's busy share of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evs = [(_dev_us(e), e.count) for e in prof.key_averages()]
    ms = sum(t for t, _ in evs) / 1e3 / steps
    return {"device_ms": ms, "launches": sum(c for t, c in evs if t > 0) / steps,
            "busy": ms / wall_ms}


def _profile_grads(run, wall_ms_a_grad):
    """A sampler run (``run() -> (HMCResult, wall)``) under ``torch.profiler``:
    its device ms and kernel launches a gradient, NCCL's kernels (which spin
    while they wait for the other ranks) apart from the rest, and the rest's
    share of ``wall_ms_a_grad``, an unprofiled run's wall a gradient."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, _ = run()
    evs = [(e.key, _dev_us(e), e.count) for e in prof.key_averages()]
    g = res.num_grad_evals
    nccl = sum(t for k, t, _ in evs if "nccl" in k.lower()) / 1e3 / g
    compute = sum(t for _, t, _ in evs) / 1e3 / g - nccl
    return {"grads": g, "compute_ms": compute, "nccl_ms": nccl,
            "launches": sum(c for _, t, c in evs if t > 0) / g,
            "compute_busy": compute / wall_ms_a_grad}


def _maxabs(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _rel(a, b):
    """max |a - b| / max |b| in float64 (complex128) on the host."""
    a, b = (torch.as_tensor(v).detach().cpu() for v in (a, b))
    dt = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    a, b = a.to(dt), b.to(dt)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _check(label, err, tol):
    if not err <= tol:
        raise AssertionError(f"{label}: {err:.3e} > {tol:.1e}")
    return err


class _Ctx:
    def __init__(self, cfg):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        self.on_card = self.dev.type == "cuda"
        self.cfg = cfg
        self.kernels = _Kernels(self.on_card)

    def log(self, *a):
        if self.rank == 0:
            print(*a, flush=True)


# tolerances, each with its reason (the first four-card run's measurements
# are in PERF.md beside them)
TOL = {
    # one Rprop step from the same point: the same signs give the same raw
    # values; the losses sum the members in another order
    "fleet_loss": 1e-6, "fleet_raw": 1e-6,
    # float32 at n = 2^20: the sharded path (general solver, one
    # reduce-scatter a transform) against the one-card path (the permuted
    # solver for the lattice); both within float32's rounding of a sum of
    # 2^20 terms
    "seq_loss32": 1e-4, "seq_grad32": 1e-3,
    # float64 at n = 2^16: the JAX package's sharded-against-unsharded bar
    "seq_loss64": 1e-10, "seq_grad64": 1e-8,
    # the transforms at n = 2^20, float32, relative to the largest output
    "transform32": 1e-5,
    # HMC's first iterations against the one-card sampler on the same row
    # blocks: float32 positions after 4 trajectories
    "hmc_first": 1e-5,
    # the sequence-mesh paths at n = 2^20, float32, relative to the largest
    # value: the sharded path (the general solver, a reduce-scatter a
    # transform, an all-reduce a query chunk, all-to-alls for mt_dnb2)
    # against one card's (the permuted solver for the lattice), each ~10x
    # the largest error measured on four NVIDIA H100 80GB HBM3 at 700 W
    # (PERF.md): serving means 1.2e-4, variances 7.8e-6, coefficients
    # 2.2e-4; mt_dnb2's MLL 6.3e-8 and gradient 5.9e-6; the log-density of
    # 8 chains 7.3e-7 and its gradient 5.9e-5.  The cubature mean and
    # variance measured 6e-8 and 0, and are held at 1e-5 and 1e-4
    "serve_mean32": 1e-3, "serve_var32": 1e-4, "serve_coeffs32": 3e-3,
    "serve_cmean32": 1e-5, "serve_cvar32": 1e-4,
    "mt_loss32": 1e-6, "mt_grad32": 1e-4,
    "hmc_lp32": 1e-5, "hmc_grad32": 1e-3,
}


def fleet_check(ctx, name, axes=None):
    """The data-parallel fit step of a fleet against the one-card step, over
    ``{"batch": D}`` or the mesh ``axes`` (the 2-D ``{"batch": 2, "seq": D /
    2}``, the fleet sequence-sharded over ``"seq"``)."""
    from ..fit.rprop import rprop_init, rprop_update

    n = ctx.cfg["n_fleet"]
    gp = _fleet(name, n, ctx.cfg["dtype"], ctx.dev)
    B = gp.shape_batch[0]
    axes = axes or {"batch": ctx.world}
    mesh = make_mesh(axes)
    if "seq" in axes:
        gp.use_sequence_sharding(mesh, "seq")
    step, raw, opt, data = make_sharded_fit_step(gp, mesh)
    K = ctx.kernels
    with K:
        K.reset()
        loss, raw1, _ = step(raw, opt, data)
        _sync(ctx.dev)
        counts, rows = K.counts(), {k: sorted(v) for k, v in K.rows.items()}
    out = {"loss": float(loss), "launches_a_step": counts, "rows": rows,
           "k4_shapes": K.k4_shapes()}
    # a rank's members; under a sequence mesh the lattice's transform is torch.fft
    per_rank = B // axes["batch"]
    per = {"lattice": {} if "seq" in axes else {"pfft": 1, "pifft_real": 1},
           "dnb2": {"fwht": 2}}[name]
    if ctx.on_card:
        for k, m in per.items():
            if counts[k] != m or rows.get(k) != [per_rank]:
                raise AssertionError(f"fleet {name} over {axes}: {k} launched {counts[k]} times "
                                     f"on rows {rows.get(k)}, not {m} on {per_rank}")
    group = mesh.get_group("batch") if axes["batch"] > 1 else None
    full_raw = {k: comm.all_gather_cat(v, group, 0) if v.shape != gp.params[k].raw.shape
                else v for k, v in raw1.items()}

    state = {"raw": raw, "opt": opt}

    def sharded():
        _, state["raw"], state["opt"] = step(state["raw"], state["opt"], data)
    with K:
        out["step_ms"] = _best_ms(sharded, 16, ctx.dev)
        if ctx.on_card:
            out["profile"] = _profile(sharded, 8, out["step_ms"])
    if "seq" in axes:
        gp.use_sequence_sharding(None)
    if ctx.rank == 0:
        const = B * float(gp.n.sum()) * math.log(2 * math.pi)
        lg = gp._make_loss_fn("MLL", None, B, const, 1)
        raw0, data0 = gp._raw_dict(), gp._fit_data()
        trainable = {k: p.trainable for k, p in gp.params.items()}
        loss_ref, _, grads = lg(raw0, data0)
        with torch.no_grad():
            raw_ref, _ = rprop_update(grads, rprop_init(raw0), raw0, trainable)
        out["loss_ref"] = float(loss_ref)
        out["loss_err"] = _check(f"fleet {name} over {axes} loss",
                                 abs(out["loss"] - out["loss_ref"]) / abs(out["loss_ref"]),
                                 TOL["fleet_loss"])
        out["raw_err"] = _check(f"fleet {name} over {axes} raw", max(
            _maxabs(full_raw[k] - raw_ref[k]) for k in raw_ref), TOL["fleet_raw"])
        ref = {"raw": raw0, "opt": rprop_init(raw0)}

        def one_card():
            _, _, g = lg(ref["raw"], data0)
            with torch.no_grad():
                ref["raw"], ref["opt"] = rprop_update(g, ref["opt"], ref["raw"], trainable)
        with K:
            out["one_card_step_ms"] = _best_ms(one_card, 16, ctx.dev)
    dist.barrier()
    ctx.log(f"  fleet {name} (B = {B}, n = {n}) over {axes}: loss {out['loss']:.9e}, "
            f"{out['step_ms']:.3f} ms a step"
            + (f" against {out['one_card_step_ms']:.3f} ms on one card; loss "
               f"{out['loss_err']:.2e} and raw {out['raw_err']:.2e} off the one-card step"
               if ctx.rank == 0 else "")
            + f"; launches a step {counts}, rows {rows}"
            + (f"; profile {out['profile']}" if "profile" in out else ""))
    return out


def _loss_grad(gp, metric, cv_weights=1):
    const = float(gp.n.sum()) * math.log(2 * math.pi)
    lg = gp._make_loss_fn(metric, None, 1, const, cv_weights)
    return lg, gp._fit_data()


def seq_check(ctx, name, n, dtype, metrics, tol_loss, tol_grad, timed=False):
    """``use_sequence_sharding`` against the one-card model: the loss and the
    trained parameters' gradients of each metric."""
    gp = _model(name, n, D_MAIN, dtype, ctx.dev)
    mesh = make_mesh({"seq": ctx.world})
    cvw = np.random.default_rng(3).uniform(0.5, 1.5, n)
    res = {}
    refs = {}
    if ctx.rank == 0:
        for metric in metrics:
            lg, data = _loss_grad(gp, metric, cvw if metric == "CV" else 1)
            loss, _, grads = lg(gp._raw_dict(), data)
            refs[metric] = (float(loss), grads)
            if timed and metric == "MLL":
                res["one_card_step_ms"] = _best_ms(lambda: lg(gp._raw_dict(), data), 8, ctx.dev)
    dist.barrier()
    gp.use_sequence_sharding(mesh)
    K = ctx.kernels
    for metric in metrics:
        lg, data = _loss_grad(gp, metric, cvw if metric == "CV" else 1)
        with K:
            K.reset()
            loss, _, grads = lg(gp._raw_dict(), data)
            _sync(ctx.dev)
            counts = K.counts()
        r = {"loss": float(loss), "launches": counts}
        if ctx.on_card and name == "dnb2" and counts["fwht"] < 2:
            raise AssertionError(f"seq {name} {metric}: K4 launched {counts['fwht']} times")
        if timed and metric == "MLL":
            with K:
                r["step_ms"] = _best_ms(lambda: lg(gp._raw_dict(), data), 8, ctx.dev)
                if ctx.on_card:
                    r["profile"] = _profile(lambda: lg(gp._raw_dict(), data), 4, r["step_ms"])
        if ctx.rank == 0:
            loss_ref, grads_ref = refs[metric]
            r["loss_err"] = _check(f"seq {name} {metric} loss", abs(r["loss"] - loss_ref)
                                   / abs(loss_ref), tol_loss)
            gerr = {}
            for k in ("scale", "lengthscales"):
                g, g0 = grads[k], grads_ref[k]
                # the scale's gradient of GCV and CV is a cancellation of terms
                # the size of the loss (they see the scale only through the noise)
                scale = abs(loss_ref) if (k == "scale" and metric != "MLL") else \
                    float(g0.abs().max())
                gerr[k] = float((g - g0).abs().max()) / max(scale, 1e-300)
            r["grad_err"] = _check(f"seq {name} {metric} gradient", max(gerr.values()), tol_grad)
        res[metric] = r
        ctx.log(f"  seq {name} {metric} n = {n} {str(dtype)[6:]} on {ctx.world} card(s): loss "
                f"{r['loss']:.9e}" + (f" ({r['loss_err']:.2e} off one card), gradient "
                                      f"{r['grad_err']:.2e} off" if ctx.rank == 0 else "")
                + f"; launches {counts}"
                + (f"; {r['step_ms']:.3f} ms a loss and gradient" if "step_ms" in r else "")
                + (f" against {res['one_card_step_ms']:.3f} ms on one card"
                   if "step_ms" in r and "one_card_step_ms" in res else "")
                + (f"; profile {r['profile']}" if "profile" in r else ""))
    gp.use_sequence_sharding(None)
    return res


def seq_memory(ctx, name, n):
    """Peak device memory of a rank's sequence-sharded MLL loss and gradient
    at n points, and (rank 0) of one card's unsharded one, each above what
    was allocated before the model was built."""
    out = {}
    for sharded in (True, False):
        if not sharded and ctx.rank != 0:
            break
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gp = _model(name, n, D_MAIN, torch.float32, ctx.dev)
        if sharded:
            gp.use_sequence_sharding(make_mesh({"seq": ctx.world}))
        lg, data = _loss_grad(gp, "MLL")
        lg(gp._raw_dict(), data)
        torch.cuda.synchronize()
        out["rank_gib" if sharded else "one_card_gib"] = \
            (torch.cuda.max_memory_allocated() - base) / 2**30
        del gp, lg, data
        if sharded:
            dist.barrier()
    torch.cuda.empty_cache()
    dist.barrier()
    ctx.log(f"  seq {name} MLL step n = 2^{int(math.log2(n))}: peak "
            f"{out['rank_gib']:.3f} GiB a rank on {ctx.world} card(s)"
            + (f", {out['one_card_gib']:.3f} GiB on one" if "one_card_gib" in out else ""))
    return out


def transforms_check(ctx, n):
    """The three sharded transforms at n = 2^20 (float32) against the
    one-card transforms of the same rows."""
    from ..ops import fwht as tf, transforms as tr
    from .mesh import seq_sharding_for, sharded_fftbr, sharded_fwht, sharded_ifftbr

    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, n), generator=g).to(ctx.dev)
    z = torch.complex(torch.randn((2, n), generator=g),
                      torch.randn((2, n), generator=g)).to(ctx.dev)
    mesh = make_mesh({"seq": ctx.world})
    sh = seq_sharding_for(2, mesh)
    group = mesh.get_group("seq") if ctx.world > 1 else None
    out = {}
    for name, sharded, ref, inp in (("fwht", sharded_fwht, tf.fwht, x),
                                    ("fftbr", sharded_fftbr, tr.fftbr, x),
                                    ("ifftbr", sharded_ifftbr, tr.ifftbr, z)):
        with ctx.kernels:
            got = comm.all_gather_cat(sharded(sh.block(inp).contiguous(), mesh), group, -1)
        if ctx.rank == 0:
            out[name] = _check(f"sharded {name}", _rel(got, ref(inp)), TOL["transform32"])
    dist.barrier()
    ctx.log(f"  sharded transforms at n = {n}, float32, against one card: {out}")
    return out


def _best_s(fn, reps, dev):
    """Wall seconds of the best of ``reps`` calls of ``fn``, each ended by a
    device sync."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _served(gp, xq):
    pm, pv = gp.post_mean_var(xq)
    return {"post_mean": pm, "post_var": pv, "coeffs": gp.coeffs,
            "cubature_mean": gp.post_cubature_mean(), "cubature_var": gp.post_cubature_var()}


SERVE_TOL = {"post_mean": "serve_mean32", "post_var": "serve_var32", "coeffs": "serve_coeffs32",
             "cubature_mean": "serve_cmean32", "cubature_var": "serve_cvar32"}


def seq_serving_check(ctx, name, n, nq):
    """Serving under ``use_sequence_sharding`` against the one-card model (see
    the module docstring)."""
    dt = ctx.cfg["dtype"]
    gp = _model(name, n, D_MAIN, dt, ctx.dev)
    xq = torch.as_tensor(np.random.default_rng(11).uniform(size=(nq, D_MAIN)), dtype=dt,
                         device=ctx.dev)
    K = ctx.kernels
    out = {}
    ref = None

    def request():
        gp.post_mean_var(xq)
    if ctx.rank == 0:
        with K:
            ref = _served(gp, xq)
            out["one_card_s"] = _best_s(request, 2, ctx.dev)
    dist.barrier()
    gp.use_sequence_sharding(make_mesh({"seq": ctx.world}))
    if ctx.on_card:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with K:
        K.reset()
        got = _served(gp, xq)
        _sync(ctx.dev)
        out["launches"], out["k4_shapes"] = K.counts(), K.k4_shapes()
        out["peak_gib"] = ((torch.cuda.max_memory_allocated() - base) / 2**30
                           if ctx.on_card else None)
        out["request_s"] = _best_s(request, 2, ctx.dev)
        if ctx.on_card:  # every rank: the request's collectives need them all
            out["profile"] = _profile(request, 1, out["request_s"] * 1e3)
    if ctx.on_card and name == "dnb2" and out["launches"]["fwht"] == 0:
        raise AssertionError(f"seq_serving {name}: K4 never launched")
    bad = [k for k, v in got.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"seq_serving {name}: non-finite {bad}")
    if ctx.rank == 0:
        out["errs"] = {k: _rel(got[k], ref[k]) for k in SERVE_TOL}
        for k, e in out["errs"].items():
            _check(f"seq_serving {name} {k}", e, TOL[SERVE_TOL[k]])
    dist.barrier()
    gp.use_sequence_sharding(None)
    ctx.log(f"  seq_serving {name} n = {n}, {nq} points, on {ctx.world} card(s): a request "
            f"{out['request_s']:.3f} s"
            + (f" against {out['one_card_s']:.3f} s on one card; off one card "
               f"{ {k: float(f'{e:.2e}') for k, e in out['errs'].items()} }"
               if ctx.rank == 0 else "")
            + f"; launches {out['launches']}, K4 (n, rows) {out['k4_shapes']}; peak "
            + (f"{out['peak_gib']:.3f} GiB a rank" if out["peak_gib"] is not None else "n/a")
            + (f"; profile {out['profile']}" if "profile" in out else ""))
    return out


def _mt_model(ns, dtype, device):
    """``chip_smoke.mt_model`` of mt_dnb2: ``examples/multitask.py``'s
    multi-fidelity setup at d = 8 (task l observes ``_f`` shifted by
    ``0.1 l cos(2 pi x_2)``), the noise at 1e-8, the lengthscales and the
    task kernel from seed 7 (``chip_smoke._seeded_raw``)."""
    from ..convert import load_jax_params

    T = len(ns)
    tasks = list(range(T))
    gp = _cls("dnb2")(D_MAIN, num_tasks=T, seed_for_seq=7, alpha=2, dtype=dtype, device=device)
    xs = gp.get_x_next_host(list(ns), task=tasks)
    gp.add_y_next([torch.as_tensor(_f(x) + 0.1 * l * np.cos(2 * np.pi * x[:, 2]))
                   for l, x in enumerate(xs)], task=tasks)
    rng = np.random.default_rng(7)
    raw = {k: p.raw.detach().cpu().double().numpy() for k, p in gp.params.items()}
    raw["lengthscales"] = rng.uniform(-0.5, 0.5, raw["lengthscales"].shape)
    raw["noise"] = np.full(raw["noise"].shape, math.log(1e-8))
    raw["factor_task_kernel"] = rng.uniform(0.5, 1.5, raw["factor_task_kernel"].shape)
    raw["noise_task_kernel"] = np.log(rng.uniform(0.05, 0.2, raw["noise_task_kernel"].shape))
    load_jax_params(gp, raw)
    return gp


class _CountAllToAll:
    """Counts ``comm``'s all-to-alls (forward and backward) while entered."""

    def __enter__(self):
        self.count, self.saved = 0, comm._all_to_all

        def counted(*a, **k):
            self.count += 1
            return self.saved(*a, **k)
        comm._all_to_all = counted
        return self

    def __exit__(self, *exc):
        comm._all_to_all = self.saved


def seq_multitask_check(ctx, ns, nq):
    """mt_dnb2 under a sequence mesh against the one-card model (see the
    module docstring)."""
    dt = ctx.cfg["dtype"]
    gp = _mt_model(ns, dt, ctx.dev)
    T = len(ns)
    xq = torch.as_tensor(np.random.default_rng(12).uniform(size=(nq, D_MAIN)), dtype=dt,
                         device=ctx.dev)
    K = ctx.kernels
    out = {}
    trained = [k for k, p in gp.params.items() if p.trainable]

    def served():
        pm, pv = gp.post_mean_var(xq)
        return {"post_mean": pm, "post_var": pv}
    ref = None
    if ctx.rank == 0:
        lg, data = _loss_grad(gp, "MLL")
        with K:
            loss, _, grads = lg(gp._raw_dict(), data)
            ref = {"loss": loss, **{k: grads[k] for k in trained}, **served()}
            out["one_card_step_ms"] = _best_ms(lambda: lg(gp._raw_dict(), data), 4, ctx.dev)
    dist.barrier()
    gp.use_sequence_sharding(make_mesh({"seq": ctx.world}))
    lg, data = _loss_grad(gp, "MLL")
    with K, _CountAllToAll() as a2a:
        K.reset()
        loss, _, grads = lg(gp._raw_dict(), data)
        _sync(ctx.dev)
        out["all_to_all_a_step"] = a2a.count
        out["step_launches"], out["step_k4_shapes"] = K.counts(), K.k4_shapes()
        out["step_ms"] = _best_ms(lambda: lg(gp._raw_dict(), data), 4, ctx.dev)
        K.reset()
        got = {"loss": loss, **{k: grads[k] for k in trained}, **served()}
        _sync(ctx.dev)
        out["serve_launches"], out["serve_k4_shapes"] = K.counts(), K.k4_shapes()
    if ctx.on_card and (out["step_launches"]["fwht"] == 0 or out["serve_launches"]["fwht"] == 0):
        raise AssertionError(f"seq_multitask: K4 launches {out['step_launches']} a step, "
                             f"{out['serve_launches']} serving")
    if ctx.rank == 0:
        errs = {"loss": _check("seq_multitask loss", _rel(got["loss"], ref["loss"]),
                               TOL["mt_loss32"])}
        for k in trained:
            errs[k] = _check(f"seq_multitask gradient {k}", _rel(got[k], ref[k]),
                             TOL["mt_grad32"])
        errs["post_mean"] = _check("seq_multitask post_mean",
                                   _rel(got["post_mean"], ref["post_mean"]), TOL["serve_mean32"])
        errs["post_var"] = _check("seq_multitask post_var",
                                  _rel(got["post_var"], ref["post_var"]), TOL["serve_var32"])
        out["errs"] = errs
    dist.barrier()
    gp.use_sequence_sharding(None)
    ctx.log(f"  seq_multitask mt_dnb2 n = {ns} ({T} tasks), {nq} points a task, on {ctx.world} "
            f"card(s): MLL and gradient {out['step_ms']:.3f} ms"
            + (f" against {out['one_card_step_ms']:.3f} ms on one card; off one card "
               f"{ {k: float(f'{e:.2e}') for k, e in out['errs'].items()} }"
               if ctx.rank == 0 else "")
            + f"; {out['all_to_all_a_step']} all-to-alls a step; K4 (n, rows) a step "
            f"{out['step_k4_shapes']}, serving {out['serve_k4_shapes']}")
    return out


def seq_hmc_check(ctx, name, n, kw, two_d=False):
    """The hyperposterior of a sequence-sharded model against one card's (see
    the module docstring); with ``two_d`` also on the 2-D mesh ``{"chains":
    2, "seq": D / 2}`` (``chain_sharding`` over ``"chains"``), against the
    same one-card reference."""
    from ..fit.hmc import gp_log_density, sample_gp_hyperposterior
    from .dryrun import hmc_points

    dt = ctx.cfg["dtype"]
    gp = _model(name, n, D_MAIN, dt, ctx.dev)
    C = kw["num_chains"]
    K = ctx.kernels

    def at_points(lp, sampled0, sharding=None):
        """The log-density and gradient at ``hmc_points``; with ``sharding``
        on the rank's chain block, gathered over the chains group."""
        pts = hmc_points({k: v.detach().cpu().double().numpy() for k, v in sampled0.items()}, C)
        leaves = {k: torch.as_tensor(v, dtype=dt, device=ctx.dev) for k, v in pts.items()}
        if sharding is not None:
            leaves = {k: sharding.block(v).contiguous() for k, v in leaves.items()}
        leaves = {k: v.requires_grad_(True) for k, v in leaves.items()}
        value = lp(leaves)
        grads = torch.autograd.grad(value.sum(), list(leaves.values()))
        got = {"value": value.detach(), **dict(zip(leaves, grads))}
        if sharding is not None:
            got = {k: comm.all_gather_cat(v, sharding.group, 0) for k, v in got.items()}
        return got

    def run(**extra):
        t0 = time.perf_counter()
        res, _ = sample_gp_hyperposterior(gp, **{**kw, **extra})
        _sync(ctx.dev)
        return res, time.perf_counter() - t0

    def sharded(mesh, sharding=None):
        """The sampler on ``mesh`` (chains over ``sharding``'s axis if given):
        its start against one card's, its launches, every rank's samples
        bit for bit equal."""
        label = f"seq_hmc {name}" + ("" if sharding is None else " 2-D")
        gp.use_sequence_sharding(mesh, "seq")
        with K:
            got = at_points(*gp_log_density(gp), sharding)
            K.reset()
            res, wall = run(chain_sharding=sharding)
            out = {"launches": K.counts(), "k4_shapes": K.k4_shapes()}
        if ctx.on_card and name == "dnb2" and out["launches"]["fwht"] < 2 * res.num_grad_evals:
            raise AssertionError(f"{label}: K4 launched {out['launches']['fwht']} times "
                                 f"for {res.num_grad_evals} gradients")
        rows = C // (1 if sharding is None else sharding.size)
        L = n // axis_size(mesh, "seq")
        if ctx.on_card and name == "dnb2" and not any(
                (s, r) == (L, rows) for s, r, _ in out["k4_shapes"]):
            raise AssertionError(f"{label}: K4 never ran on ({rows}, {L}) blocks: "
                                 f"{out['k4_shapes']}")
        if not bool(torch.isfinite(res.log_prob).all()):
            raise AssertionError(f"{label}: non-finite log_prob")
        if ctx.on_card:  # every rank: the sampler's collectives need them all
            with K:
                out["profile"] = _profile_grads(lambda: run(**short, chain_sharding=sharding),
                                                wall * 1e3 / res.num_grad_evals)
        # every rank's samples, log-densities and gradient count, over the world
        mine = torch.cat([res.log_prob.reshape(-1)] + [v.reshape(-1) for _, v in
                                                       sorted(res.samples.items())]
                         + [torch.tensor([float(res.num_grad_evals)], dtype=dt, device=ctx.dev)])
        every = comm.all_gather_cat(mine[None], dist.group.WORLD if ctx.world > 1 else None, 0)
        out["ranks_bitwise_equal"] = bool((every == every[:1]).all())
        if not out["ranks_bitwise_equal"]:
            raise AssertionError(f"{label}: the ranks' samples differ")
        out.update(grads=res.num_grad_evals, wall_s=wall,
                   samples_per_s=kw["num_samples"] * C / wall, accept=float(res.accept_rate),
                   step_size=float(res.step_size), mean_leapfrog=res.mean_leapfrog)
        if ctx.rank == 0:
            out["errs"] = {"value": _check(f"{label} log-density",
                                           _rel(got["value"], ref["value"]), TOL["hmc_lp32"])}
            for k in ("scale", "lengthscales"):
                out["errs"][k] = _check(f"{label} gradient {k}", _rel(got[k], ref[k]),
                                        TOL["hmc_grad32"])
            # the acceptance and step size are reported beside one card's, not
            # held: at this unfitted start the float32 surface keeps both runs'
            # steps at 1e-6-1e-4, and 20 warmup iterations of dual averaging on
            # runs that part at the first rounding leave them 3x apart (measured)
        dist.barrier()
        gp.use_sequence_sharding(None)
        ctx.log(f"  {label} n = {n}, {C} chains, {kw['num_warmup']} + {kw['num_samples']} on "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: {out['grads']} gradients, "
                f"{wall:.2f} s, {out['samples_per_s']:.2f} samples/s, accept "
                f"{out['accept']:.3f}, step size {out['step_size']:.4g}"
                + (f"; one card {one_card}; log-density and gradient off one card "
                   f"{ {k: float(f'{e:.2e}') for k, e in out['errs'].items()} }"
                   if ctx.rank == 0 else "")
                + f"; ranks bit for bit equal; launches {out['launches']}, K4 (n, rows) "
                f"{out['k4_shapes']}" + (f"; profile {out['profile']}" if "profile" in out else ""))
        return out
    # the profiled stretch: 2 + 2 iterations
    short = dict(num_warmup=2, num_samples=2)
    ref = one_card = None
    if ctx.rank == 0:
        with K:
            ref = at_points(*gp_log_density(gp))
            res1, wall1 = run()
            one_card = {"samples_per_s": kw["num_samples"] * C / wall1,
                        "accept": float(res1.accept_rate), "step_size": float(res1.step_size)}
            if ctx.on_card:
                one_card["profile"] = _profile_grads(lambda: run(**short),
                                                     wall1 * 1e3 / res1.num_grad_evals)
    dist.barrier()
    out = sharded(make_mesh({"seq": ctx.world}))
    out["one_card"] = one_card
    if two_d:
        mesh = make_mesh({"chains": 2, "seq": ctx.world // 2})
        out["two_d"] = sharded(mesh, batch_sharding(mesh, "chains"))
    return out


def _broadcast_raw(gp):
    """Rank 0's raw parameters on every rank (so that every rank samples the
    same model after a fit)."""
    raw = {k: p.raw.clone() for k, p in gp.params.items()}
    for v in raw.values():
        dist.broadcast(v, 0)
    gp._set_raw(raw)


def _blocked_hmc(gp, kw, blocks):
    """The one-card sampler with ``sample_gp_hyperposterior``'s options, its
    log-density evaluated in ``blocks`` row blocks of the chains: on the
    same rows as the ranks of a chain-sharded run, whose reductions a row
    round alike (a log-density's rounding depends on how many rows it is
    given), so that the two runs must agree to float32 rounding."""
    from ..fit.hmc import gp_log_density, hmc

    lp, sampled0 = gp_log_density(gp)
    C = kw["num_chains"]
    per = C // blocks

    def blocked(s):
        return torch.cat([lp({k: v[per * r:per * (r + 1)] for k, v in s.items()})
                          for r in range(blocks)])
    return hmc(blocked, sampled0, kw["seed"], num_samples=kw["num_samples"],
               num_warmup=kw["num_warmup"], num_chains=C, num_leapfrog=32,
               trajectory_jitter=0.5, mass_decay=0.99, mass_warmup_start_frac=0.25,
               mass_matrix="dense", trajectory_adapt="chees",
               target_accept=0.9 if gp.dtype == torch.float64 else 0.8,
               max_leapfrog=kw.get("max_leapfrog"))


def hmc_check(ctx, label, gp, kw):
    """Chain-sharded ``sample_gp_hyperposterior`` against the one-card
    sampler: its first 4 iterations against the one-card sampler on the same
    rows a block (``_blocked_hmc``) and, for the record, against the plain
    one-card run; a whole (timed) run's acceptance and step size against
    the plain one-card run's.  Both runs' launches are counted from 0 and
    held to one K1 and one K2 a gradient on the rank's chains; the whole
    run's are returned as ``launches``."""
    from ..fit.hmc import sample_gp_hyperposterior

    mesh = make_mesh({"chains": ctx.world})
    sharding = batch_sharding(mesh, "chains")
    gp._warm_for_fit()
    # four iterations (the diagnostics need two a split half)
    first = dict(kw, num_warmup=0, num_samples=4)
    K = ctx.kernels
    per_rank = C_HMC // ctx.world

    def launched(run):
        """The run, its launches and their rows; on the card one K1 and one
        K2 a gradient, each on the rank's chains."""
        K.reset()
        res, diag = run()
        _sync(ctx.dev)
        counts, rows = K.counts(), {k: sorted(v) for k, v in K.rows.items()}
        grads = res.num_grad_evals
        if ctx.on_card and (counts["pfft"] != grads or counts["pifft_real"] != grads
                            or rows.get("pfft") != [per_rank]):
            raise AssertionError(f"{label}: launches {counts} on rows {rows} for {grads} "
                                 f"gradients of {per_rank} chains a rank")
        return res, diag, counts, rows

    with K:
        res1, _, counts1, _ = launched(
            lambda: sample_gp_hyperposterior(gp, chain_sharding=sharding, **first))
        t0 = time.perf_counter()
        res, diag, counts, rows = launched(
            lambda: sample_gp_hyperposterior(gp, chain_sharding=sharding, **kw))
        wall = time.perf_counter() - t0
    grads = res1.num_grad_evals
    if not bool(torch.isfinite(res.log_prob).all() and torch.isfinite(res1.log_prob).all()):
        raise AssertionError(f"{label}: non-finite log_prob")
    out = {"first_grads": grads, "first_launches": counts1, "grads": res.num_grad_evals,
           "launches": counts, "rows": rows, "wall_s": wall,
           "samples_per_s": kw["num_samples"] * C_HMC / wall,
           "accept": float(res.accept_rate), "step_size": float(res.step_size),
           "mean_leapfrog": res.mean_leapfrog, "rhat": max(v["rhat"] for v in diag.values())}
    if ctx.rank == 0:
        with K:
            same_rows = _blocked_hmc(gp, first, ctx.world)
            plain1, _ = sample_gp_hyperposterior(gp, **first)
            ref, _ = sample_gp_hyperposterior(gp, **kw)
        out["first_err"] = _check(f"{label} first iterations", max(
            _rel(res1.samples[k], same_rows.samples[k]) for k in same_rows.samples),
            TOL["hmc_first"])
        out["first_err_plain"] = max(_rel(res1.samples[k][0], plain1.samples[k][0])
                                     for k in plain1.samples)
        out["one_card"] = {"accept": float(ref.accept_rate), "step_size": float(ref.step_size)}
        if ctx.world == 1:  # a group of one runs the unsharded sampler's rows: the same run
            out["run_err"] = _check(f"{label} whole run", max(
                _rel(res.samples[k], ref.samples[k]) for k in ref.samples), TOL["hmc_first"])
        # as distributions: dual averaging drives both to the same target
        # acceptance, and their step sizes to the same scale
        if not (abs(out["accept"] - out["one_card"]["accept"]) < 0.25
                and 0.5 < out["step_size"] / out["one_card"]["step_size"] < 2.0):
            raise AssertionError(f"{label}: acceptance / step size {out['accept']:.3f} / "
                                 f"{out['step_size']:.4g} against one card's {out['one_card']}")
    dist.barrier()
    ctx.log(f"  {label} over {ctx.world} card(s): first 4 iterations {grads} gradients, launches "
            f"{counts1}; whole run {out['grads']} gradients, launches {counts}, rows {rows}"
            + (f", {out['first_err']:.2e} off one card on the same row blocks (the first "
               f"iteration {out['first_err_plain']:.2e} off the plain one-card run)"
               if ctx.rank == 0 else "")
            + f"; whole run {wall:.2f} s, {out['samples_per_s']:.2f} samples/s, accept "
            f"{out['accept']:.3f}, step size {out['step_size']:.4g}"
            + (f" (one card {out['one_card']})" if ctx.rank == 0 else ""))
    return out


def body(rank, world, cfg):
    """The parallel phase on ``world`` ranks (see the module docstring);
    ``cfg``: ``full`` (the four-card set), ``dtype``, and the sizes
    ``n_fleet``, ``n_seq``, ``n_seq64``, ``n_mem``, ``n_hmc``, ``n_flag``,
    ``n_query``, ``mt_ns``, ``n_query_mt``, ``hmc_lattice`` and
    ``hmc_flagship`` (sampler options)."""
    from . import distributed as D
    from .dryrun import dryrun_multichip

    ctx = _Ctx(cfg)
    full = cfg["full"]
    # the 2-D meshes {"chains": 2, "seq": D / 2} and {"batch": 2, "seq": D / 2}
    two_d = full and world >= 4 and world % 2 == 0
    res = {"cards": world}
    t0 = time.perf_counter()
    if full:
        res["seq_serving"] = {name: seq_serving_check(ctx, name, cfg["n_seq"], cfg["n_query"])
                              for name in ("lattice", "dnb2")}
        res["seq_multitask"] = seq_multitask_check(ctx, cfg["mt_ns"], cfg["n_query_mt"])
        res["seq_hmc"] = {name: seq_hmc_check(ctx, name, cfg["n_flag"], cfg["hmc_flagship"],
                                              two_d=two_d) for name in ("lattice", "dnb2")}
        res["seq_paths_s"] = time.perf_counter() - t0
    res["fleet"] = {name: fleet_check(ctx, name) for name in ("lattice", "dnb2")}
    if two_d:
        res["fleet_2d"] = {name: fleet_check(ctx, name, {"batch": 2, "seq": world // 2})
                           for name in ("lattice", "dnb2")}
    names = ("lattice", "dnb2") if full else ("dnb2",)
    metrics = ("MLL", "GCV", "CV") if full else ("MLL",)
    res["seq"] = {name: seq_check(ctx, name, cfg["n_seq"], cfg["dtype"], metrics,
                                  TOL["seq_loss32"], TOL["seq_grad32"], timed=True)
                  for name in names}
    if full:
        res["seq64"] = {name: seq_check(ctx, name, cfg["n_seq64"], torch.float64, metrics,
                                        TOL["seq_loss64"], TOL["seq_grad64"]) for name in names}
        res["transforms"] = transforms_check(ctx, cfg["n_seq"])
        if ctx.on_card:
            res["memory"] = {n: seq_memory(ctx, "dnb2", n) for n in cfg["n_mem"]}
    gp = _model("lattice", cfg["n_hmc"], 4, cfg["dtype"], ctx.dev)
    with ctx.kernels:
        gp.fit(iterations=30, verbose=0)
    _broadcast_raw(gp)
    res["hmc"] = {"hmc_lattice": hmc_check(ctx, "hmc_lattice", gp, cfg["hmc_lattice"])}
    hmc_models = {"hmc_lattice": gp}
    if full:
        gpf = _model("lattice", cfg["n_flag"], D_MAIN, cfg["dtype"], ctx.dev)
        res["hmc"]["hmc_flagship"] = hmc_check(ctx, "hmc_flagship", gpf, cfg["hmc_flagship"])
        hmc_models["hmc_flagship"] = gpf
    counts = (1, world) if world > 1 else (1,)
    with ctx.kernels:
        res["collective"] = D.measure_collective_overhead(num_chains=C_HMC, device_counts=counts,
                                                          steps=500)
        ctx.log(f"  scalar all-reduce a step: {res['collective']['latency_s']}")
        if full:
            res["scaling"] = {}
            for label, m in hmc_models.items():
                kw = dict(cfg[label])
                kw.pop("num_chains", None)
                res["scaling"][label] = D.measure_hmc_scaling(m, num_chains=C_HMC,
                                                              device_counts=counts, **kw)
                ctx.log(f"  measure_hmc_scaling {label}: {res['scaling'][label]}")
            res["dryrun"] = dryrun_multichip(world)
            ctx.log(f"  dryrun_multichip({world}): {res['dryrun']}")

    res["seconds"] = time.perf_counter() - t0
    return res
