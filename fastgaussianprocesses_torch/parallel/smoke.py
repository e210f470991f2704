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
  step's, and a profile of it (device busy share, launches a step);
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
  ``dryrun_multichip(D)``.

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
from .mesh import batch_sharding, make_mesh, make_sharded_fit_step

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
    made to raise (on the card), and the rows of every launch."""

    def __init__(self, on_card):
        from ..ops import fwht as tf, perm_fft as tp
        self.tp, self.tf, self.on_card = tp, tf, on_card
        self.rows = {}

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
                self.rows.setdefault(_name, set()).add(x.numel() // x.shape[-1])
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


def _profile(fn, steps, wall_ms):
    """Device ms and kernel launches a step under ``torch.profiler`` (CUDA
    activity only), and the device's busy share of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            return 0.0
        return float(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evs = [(dev_us(e), e.count) for e in prof.key_averages()]
    ms = sum(t for t, _ in evs) / 1e3 / steps
    return {"device_ms": ms, "launches": sum(c for t, c in evs if t > 0) / steps,
            "busy": ms / wall_ms}


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
}


def fleet_check(ctx, name):
    """The data-parallel fit step of a fleet against the one-card step."""
    from ..fit.rprop import rprop_init, rprop_update

    n = ctx.cfg["n_fleet"]
    gp = _fleet(name, n, ctx.cfg["dtype"], ctx.dev)
    B = gp.shape_batch[0]
    mesh = make_mesh({"batch": ctx.world})
    step, raw, opt, data = make_sharded_fit_step(gp, mesh)
    K = ctx.kernels
    with K:
        K.reset()
        loss, raw1, _ = step(raw, opt, data)
        _sync(ctx.dev)
        counts, rows = K.counts(), {k: sorted(v) for k, v in K.rows.items()}
    out = {"loss": float(loss), "launches_a_step": counts, "rows": rows}
    per = {"lattice": {"pfft": 1, "pifft_real": 1}, "dnb2": {"fwht": 2}}[name]
    if ctx.on_card:
        for k, m in per.items():
            if counts[k] != m or rows.get(k) != [B // ctx.world]:
                raise AssertionError(f"fleet {name}: {k} launched {counts[k]} times on rows "
                                     f"{rows.get(k)}, not {m} on {B // ctx.world}")
    group = mesh.get_group("batch") if ctx.world > 1 else None
    full_raw = {k: comm.all_gather_cat(v, group, 0) if v.shape != gp.params[k].raw.shape
                else v for k, v in raw1.items()}

    state = {"raw": raw, "opt": opt}

    def sharded():
        _, state["raw"], state["opt"] = step(state["raw"], state["opt"], data)
    with K:
        out["step_ms"] = _best_ms(sharded, 16, ctx.dev)
        if ctx.on_card:
            out["profile"] = _profile(sharded, 8, out["step_ms"])
    if ctx.rank == 0:
        const = B * float(gp.n.sum()) * math.log(2 * math.pi)
        lg = gp._make_loss_fn("MLL", None, B, const, 1)
        raw0, data0 = gp._raw_dict(), gp._fit_data()
        trainable = {k: p.trainable for k, p in gp.params.items()}
        loss_ref, _, grads = lg(raw0, data0)
        with torch.no_grad():
            raw_ref, _ = rprop_update(grads, rprop_init(raw0), raw0, trainable)
        out["loss_ref"] = float(loss_ref)
        out["loss_err"] = _check(f"fleet {name} loss", abs(out["loss"] - out["loss_ref"])
                                 / abs(out["loss_ref"]), TOL["fleet_loss"])
        out["raw_err"] = _check(f"fleet {name} raw", max(
            _maxabs(full_raw[k] - raw_ref[k]) for k in raw_ref), TOL["fleet_raw"])
        ref = {"raw": raw0, "opt": rprop_init(raw0)}

        def one_card():
            _, _, g = lg(ref["raw"], data0)
            with torch.no_grad():
                ref["raw"], ref["opt"] = rprop_update(g, ref["opt"], ref["raw"], trainable)
        with K:
            out["one_card_step_ms"] = _best_ms(one_card, 16, ctx.dev)
    dist.barrier()
    ctx.log(f"  fleet {name} (B = {B}, n = {n}): loss {out['loss']:.9e}, "
            f"{out['step_ms']:.3f} ms a step on {ctx.world} card(s)"
            + (f" against {out['one_card_step_ms']:.3f} ms on one; loss {out['loss_err']:.2e} "
               f"and raw {out['raw_err']:.2e} off the one-card step" if ctx.rank == 0 else "")
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
    ``hmc_lattice`` and ``hmc_flagship`` (sampler options)."""
    from . import distributed as D
    from .dryrun import dryrun_multichip

    ctx = _Ctx(cfg)
    full = cfg["full"]
    res = {"cards": world}
    t0 = time.perf_counter()
    res["fleet"] = {name: fleet_check(ctx, name) for name in ("lattice", "dnb2")}
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
