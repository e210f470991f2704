"""Serving traffic (``"kind": "serve"``): one closed-loop client, sending a
request when the last has come back, each request one ``post_mean_var`` of
``points_per_request`` query points drawn uniform in [0, 1)^d from the seed.

Parameters of the mix: ``points_per_request``, ``pool_requests`` (the
distinct requests drawn in set-up and sent in turn), ``check_requests`` (the
completed requests that the reference checks, drawn from the seed),
``trace_requests`` (requests in the traced window).
"""

import time

import numpy as np
import torch

from . import program
from .program import worst
from gpbench.reference.precision import Precision

TRACE_UNITS = "trace_requests"
CHIPS = (1,)


def setup(run):
    t = run.traffic
    cfg, dev = run.cfg, run.device
    run.values = program.draw_hyperparameters(cfg, run.seed)
    run.gp = program.build(cfg, run.values, dev)
    g = torch.Generator(device=dev).manual_seed(int(run.seed))
    dt = getattr(torch, cfg["dtype"])
    run.pool = torch.rand((int(t["pool_requests"]), int(t["points_per_request"]), int(cfg["d"])),
                          generator=g, device=dev, dtype=dt)
    # the process's first request, timed apart, then one more of the same
    # shapes: every shape the window sends is warm
    t0 = time.perf_counter()
    run.gp.post_mean_var(run.pool[0])
    program.sync(dev)
    run.setup["first_request_ms"] = (time.perf_counter() - t0) * 1e3
    run.gp.post_mean_var(run.pool[1])
    program.sync(dev)


def window(run, seconds, max_units=None):
    """Requests until the deadline (or ``max_units``); the one under way at
    the deadline is finished and counted.  Returns the window's seconds."""
    gp, pool, dev = run.gp, run.pool, run.device
    run.outputs = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while time.perf_counter() < deadline and (max_units is None or k < max_units):
        i = k % pool.shape[0]
        run.attempted += 1
        try:
            with run.span("gpbench.request"):
                pm, pv = gp.post_mean_var(pool[i])
                program.sync(dev)
            run.outputs.append((i, pm, pv))
        except RuntimeError as exc:
            run.failed += 1
            run.errors.append(repr(exc))
        k += 1
    elapsed = time.perf_counter() - t0
    n = len(run.outputs) * pool.shape[1]
    run.work = {"requests": len(run.outputs), "points": n}
    return elapsed


def end_to_end(run, name, elapsed):
    if name == "serve_points_per_s":
        return run.work["points"] / elapsed
    raise KeyError(name)


def release(run):
    run.outputs = [(i, pm.detach().to("cpu", torch.float64), pv.detach().to("cpu", torch.float64))
                   for i, pm, pv in run.outputs]
    run.pool = run.pool.to("cpu")
    del run.gp


def check(run, reference_cls, control=None):
    """The largest gaps of the checked requests' means (against the largest
    mean) and variances (against the prior variance) from the float64
    reference's; with ``control``, a precision's name (``"bfloat16"``: the
    control), of the reference computed in it in the program's place."""
    if not run.outputs:
        return {"mean_gap": float("inf"), "var_gap": float("inf")}
    rng = np.random.default_rng([int(run.seed), 2])
    k = min(int(run.traffic["check_requests"]), len(run.outputs))
    picks = sorted(rng.choice(len(run.outputs), size=k, replace=False).tolist())
    raw = program.raw_values(run.cfg, run.values, run.device)
    ref = reference_cls(run.cfg, run.device)
    low = reference_cls(run.cfg, run.device, Precision(control)) if control else None
    mean_gaps, var_gaps = [], []
    for j in picks:
        i, pm, pv = run.outputs[j]
        xq = run.pool[i].to(run.device, torch.float64)
        rm, rv = ref.posterior(raw, xq)
        if control:
            pm, pv = low.posterior(raw, xq)
        rm, rv = rm.cpu(), rv.cpu()
        mean_gaps.append(float((pm.cpu() - rm).abs().max() / rm.abs().max()))
        var_gaps.append(float((pv.cpu() - rv).abs().max()) / ref.prior_variance(raw))
    return {"mean_gap": worst(mean_gaps), "var_gap": worst(var_gaps)}
