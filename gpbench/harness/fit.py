"""Fitting traffic (``"kind": "fit"``): repeated ``fit`` calls, each from the
seed's hyperparameters, with early stopping off, so that every fit does the
same work.

The loss is the MLL, which the reference computes.  Parameters of the mix:
``iterations`` (a fit computes ``iterations + 1`` steps),
``stop_crit_wait_iterations``, ``steps_per_dispatch`` (null: the card's
default), ``reference_steps`` (the first steps whose gradient and change of
the parameters are compared), ``trace_fits`` (fits in the traced window).

Set-up drives the model from the seed through its first steps with the
window's own call, checkpointing each step: one step, whose Rprop state
holds the first gradient as the optimizer got it, then
``reference_steps``, whose state holds the parameters after them; then one
whole fit warms the window's shapes.  The reference follows the whole fit:
every step's loss, across the dispatches, and the parameters that ``fit``
leaves behind (the best step's) are compared for every window fit.
"""

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from . import program
from .program import worst
from gpbench.reference.precision import Precision
from gpbench.reference.rprop import rprop_fit


TRACE_UNITS = "trace_fits"
CHIPS = (1,)


def _kw(t):
    return dict(loss_metric="MLL", stop_crit_wait_iterations=int(t["stop_crit_wait_iterations"]),
                steps_per_dispatch=t.get("steps_per_dispatch"), verbose=0)


def _checkpointed(run, iterations, path):
    run.gp._set_raw(run.start_raw)
    run.gp.fit(iterations=iterations, checkpoint_path=path, checkpoint_every=1, **_kw(run.traffic))
    with np.load(path) as ck:
        return {k: ck[k].copy() for k in ck.files}


def setup(run):
    cfg, t, dev = run.cfg, run.traffic, run.device
    run.values = program.draw_hyperparameters(cfg, run.seed)
    run.gp = program.build(cfg, run.values, dev)
    run.start_raw = {k: p.raw.clone() for k, p in run.gp.params.items()}
    run.trainable = [k for k, p in run.gp.params.items() if p.trainable]
    tmp = tempfile.mkdtemp(prefix="gpbench-fit-")
    try:
        one = _checkpointed(run, 0, os.path.join(tmp, "one.npz"))
        steps = int(t["reference_steps"])
        last = _checkpointed(run, steps - 1, os.path.join(tmp, "last.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run.first_grad = {k: one[f"pg_{k}"] for k in run.trainable}
    run.after = {k: last[f"raw_{k}"] for k in run.trainable}
    run.start_host = {k: run.start_raw[k].double().cpu().numpy() for k in run.trainable}
    run.gp._set_raw(run.start_raw)
    run.gp.fit(iterations=int(t["iterations"]), store_loss_hist=True, **_kw(t))
    program.sync(dev)


def window(run, seconds, max_units=None):
    """Fits until the deadline (or ``max_units``); the one under way at the
    deadline is finished and counted."""
    t, gp, dev = run.traffic, run.gp, run.device
    run.losses, run.finals = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline and (max_units is None or len(run.losses) < max_units):
        run.attempted += 1
        try:
            with run.span("gpbench.fit"):
                gp._set_raw(run.start_raw)
                out = gp.fit(iterations=int(t["iterations"]), store_loss_hist=True, **_kw(t))
                final = {k: gp.params[k].raw.detach().clone() for k in run.trainable}
                program.sync(dev)
            run.losses.append(-np.asarray(out["loss_hist"], dtype=np.float64))
            run.finals.append(final)
        except RuntimeError as exc:
            run.failed += 1
            run.errors.append(repr(exc))
    elapsed = time.perf_counter() - t0
    run.work = {"fits": len(run.losses), "steps": int(sum(len(h) for h in run.losses))}
    return elapsed


def end_to_end(run, name, elapsed):
    if name == "fit_step_ms":
        return 1e3 * elapsed / run.work["steps"]
    raise KeyError(name)


def release(run):
    run.finals = [{k: v.double().cpu().numpy() for k, v in f.items()} for f in run.finals]
    del run.gp


def counted_leaves(grad):
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's: a leaf below that moves under Rprop by round-off."""
    norms = {k: float(np.linalg.norm(v)) for k, v in grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k in grad if norms[k] >= 1e-3 * med]


def _leaf_gaps(got, want, leaves):
    """Worst of the ``leaves`` of ``| |got_k| - |want_k| | / max(|want_k|,
    median leaf norm)``: the gap between the two norms, not the norm of the
    difference."""
    norms = {k: float(np.linalg.norm(want[k])) for k in want}
    med = float(np.median(list(norms.values())))
    return worst([abs(float(np.linalg.norm(got[k])) - norms[k]) / max(norms[k], med)
                  for k in leaves] or [0.0])


def _distinct(finals):
    """The distinct parameter sets among the window fits' ``finals``."""
    out = []
    for f in finals:
        if not any(all(np.array_equal(f[k], g[k]) for k in f) for g in out):
            out.append(f)
    return out


def check(run, reference_cls, control=None):
    """Against the float64 reference's Rprop fit from the same start: every
    step's loss of every window fit (``loss_gap``), the first gradient
    (``grad_gap``) and the parameters' change after ``reference_steps``
    (``step_gap``), and the parameters that every window fit left behind,
    by the reference's loss there against its loss at its own best step
    (``final_gap``).  With ``control``, a precision's name (``"bfloat16"``:
    the control), the reference's own fit computed in it takes the
    program's place."""
    t = run.traffic
    steps, first = int(t["iterations"]) + 1, int(t["reference_steps"])
    raw = program.raw_values(run.cfg, run.values, run.device)
    raw = {k: v[0] for k, v in raw.items()}
    keep = {k: v for k, v in raw.items() if k in run.trainable}
    fixed = {k: v for k, v in raw.items() if k not in run.trainable}

    def fit_of(ref):
        return rprop_fit(lambda leaves: ref.mll_loss({**fixed, **leaves}), keep, steps, first)

    ref = reference_cls(run.cfg, run.device)
    want = fit_of(ref)
    want_g = {k: v.cpu().numpy() for k, v in want.first_grad.items()}
    want_step = {k: (want.after_first[k] - keep[k]).cpu().numpy() for k in keep}
    if control:
        got = fit_of(reference_cls(run.cfg, run.device, Precision(control)))
        losses = [np.asarray(got.losses)]
        got_g = {k: v.cpu().numpy() for k, v in got.first_grad.items()}
        got_step = {k: (got.after_first[k] - keep[k]).cpu().numpy() for k in keep}
        finals = [{k: v.cpu().numpy() for k, v in got.best.items()}]
    else:
        losses = run.losses
        got_g = run.first_grad
        got_step = {k: run.after[k] - run.start_host[k] for k in keep}
        finals = _distinct(run.finals)
    if not losses or not finals:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "step_gap": math.inf,
                "final_gap": math.inf}
    want_loss = np.asarray(want.losses)
    loss_gap = worst([float(np.max(np.abs(h - want_loss) / np.abs(want_loss)))
                      if h.shape == want_loss.shape else math.inf for h in losses])
    best = float(ref.mll_loss({**fixed, **want.best}))
    with torch.no_grad():
        final_gap = worst([abs(float(ref.mll_loss(
            {**fixed, **{k: torch.as_tensor(v, device=run.device) for k, v in f.items()}}))
            - best) / abs(best) for f in finals])
    leaves = counted_leaves(want_g)
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gaps(got_g, want_g, leaves),
            "step_gap": _leaf_gaps(got_step, want_step, leaves), "final_gap": final_gap}
