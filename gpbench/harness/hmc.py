"""Hyperposterior traffic (``"kind": "hmc"``): calls of
``sample_gp_hyperposterior`` that each resume from the last call's state.

Parameters of the mix: ``chains``, ``num_leapfrog``, ``trajectory_adapt``
and ``trajectory_jitter`` (fixed, unjittered: every iteration does the same
work), ``mass_matrix``, ``prior_std``, ``warmup`` (the adaptation, run in
set-up by one call of ``warmup`` iterations and ``iterations_per_call``
samples, the window's shapes), ``iterations_per_call``, ``trace_calls``
(calls in the traced window).
"""

TRACE_UNITS = "trace_calls"
CHIPS = (1,)

import math
import time

import numpy as np
import torch

from . import program
from .program import worst
from gpbench.reference.precision import Precision

INCLUDE = ("scale", "lengthscales")


def _call(run, state):
    from fastgaussianprocesses_torch.fit.hmc import sample_gp_hyperposterior

    t = run.traffic
    res, _ = sample_gp_hyperposterior(
        run.gp, num_samples=int(t["iterations_per_call"]), num_warmup=int(t["warmup"]),
        num_chains=int(t["chains"]), seed=int(run.seed), prior_std=float(t["prior_std"]),
        include=INCLUDE, num_leapfrog=int(t["num_leapfrog"]),
        trajectory_jitter=float(t["trajectory_jitter"]), mass_matrix=t["mass_matrix"],
        trajectory_adapt=t["trajectory_adapt"], resume_state=state)
    return res


def setup(run):
    run.values = program.draw_hyperparameters(run.cfg, run.seed)
    run.gp = program.build(run.cfg, run.values, run.device)
    res = _call(run, None)
    program.sync(run.device)
    run.state = res.state


def window(run, seconds, max_units=None):
    """Calls until the deadline (or ``max_units``); the one under way at the
    deadline is finished and counted."""
    run.calls, accepts = [], []
    grads = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline and (max_units is None or len(run.calls) < max_units):
        run.attempted += 1
        try:
            with run.span("gpbench.hmc_call"):
                res = _call(run, run.state)
                program.sync(run.device)
        except RuntimeError as exc:
            run.failed += 1
            run.errors.append(repr(exc))
            continue
        # the call's states (each leaf (iterations, chains, ...)), the
        # program's log-densities at them, and the sampler's step counter
        # before and after the call
        run.calls.append(({k: v.detach() for k, v in res.samples.items()},
                          res.log_prob.detach(), int(run.state[1]), int(res.state[1])))
        run.state = res.state
        grads += res.num_grad_evals
        accepts.append(res.accept_rate)
    elapsed = time.perf_counter() - t0
    chains = int(run.traffic["chains"])
    run.accepts = [float(a) for a in accepts]
    run.work = {"calls": len(run.calls), "grads": grads,
                "samples": len(run.calls) * int(run.traffic["iterations_per_call"]) * chains}
    return elapsed


def end_to_end(run, name, elapsed):
    if name == "hmc_samples_per_s":
        return run.work["samples"] / elapsed
    raise KeyError(name)


def _pick(run):
    rng = np.random.default_rng([int(run.seed), 2])
    return run.calls[int(rng.integers(len(run.calls)))]


def release(run):
    """Before the program's state is freed: its gradients at the checked
    call's last states, through the log-density that the sampler itself
    builds (``gp_log_density``), at the window's shapes (every chain a row)."""
    from fastgaussianprocesses_torch.fit.hmc import gp_log_density

    run.checked = _pick(run) if run.calls else None
    if run.checked is not None:
        logprob, _ = gp_log_density(run.gp, include=INCLUDE,
                                    prior_std=float(run.traffic["prior_std"]))
        last = {k: v[-1].clone().requires_grad_(True) for k, v in run.checked[0].items()}
        with torch.enable_grad():
            lp = logprob(last)
            grads = torch.autograd.grad(lp.sum(), [last[k] for k in INCLUDE])
        run.grads = {k: g.detach().double().cpu() for k, g in zip(INCLUDE, grads)}
    del run.gp


def _grad_gap(got, want):
    """Worst leaf of ``|got_k - want_k| / |want_k|``, the norms taken over
    every chain and component of the leaf: a zeroed gradient reads 1, one of
    the wrong sign 2."""
    return worst([float((got[k] - want[k]).norm() / want[k].norm()) for k in want])


def iterations_per_accept(accepts):
    """The worst call's iterations a chain waits for an accepted proposal:
    one over its acceptance rate, infinite where it accepted none."""
    return max(math.inf if a <= 0 else 1.0 / a for a in accepts)


def check(run, reference_cls, control=None):
    """At the checked call's states: the largest gap of the program's
    log-densities from the float64 reference's (against the reference's
    magnitude), the gap of the gradients at its last states (``_grad_gap``),
    how far the sampler's step counter moved from the call's iterations
    (every call), how many of the call's last states repeat another chain's
    (the chains start apart and draw their own momenta, so none does), and
    the worst call's iterations a chain waits for an accepted proposal
    (``iterations_per_accept``).  With ``control``, a
    precision's name (``"bfloat16"``: the control), the reference computed
    in it takes the program's place in the first two."""
    if run.checked is None:
        return {"logp_gap": math.inf, "grad_gap": math.inf, "state_step_gap": math.inf,
                "dup_chains": math.inf, "iterations_per_accept": math.inf}
    samples, log_prob = run.checked[:2]
    prior_std = float(run.traffic["prior_std"])
    raw0 = program.raw_values(run.cfg, run.values, run.device)
    ref = reference_cls(run.cfg, run.device)
    low = reference_cls(run.cfg, run.device, Precision(control)) if control else None
    its, C = log_prob.shape

    def log_density(model, s):
        # the states in blocks of a call's chains, so that the float64
        # eigenvalues of every state are never live at once
        flat = {k: s[k].reshape((its * C,) + tuple(s[k].shape[2:])).to(run.device, torch.float64)
                for k in INCLUDE}
        return torch.cat([model.log_density({k: v[i:i + C] for k, v in flat.items()}, raw0,
                                            prior_std) for i in range(0, its * C, C)])

    with torch.no_grad():
        want = log_density(ref, samples)
        got = (log_density(low, samples) if control
               else log_prob.reshape(-1).to(run.device, torch.float64))
    logp_gap = worst(((got - want).abs() / want.abs()).tolist())

    def grads_of(model):
        last = {k: samples[k][-1].to(run.device, torch.float64).requires_grad_(True)
                for k in INCLUDE}
        with torch.enable_grad():
            lp = model.log_density(last, raw0, prior_std)
            g = torch.autograd.grad(lp.sum(), [last[k] for k in INCLUDE])
        return {k: v.detach().cpu() for k, v in zip(INCLUDE, g)}

    want_g = grads_of(ref)
    got_g = grads_of(low) if control else run.grads
    per_call = int(run.traffic["iterations_per_call"])
    step_gap = max(abs((t1 - t0) - per_call) for _, _, t0, t1 in run.calls)
    last = torch.cat([samples[k][-1].reshape(C, -1) for k in INCLUDE], -1)
    return {"logp_gap": logp_gap, "grad_gap": _grad_gap(got_g, want_g),
            "state_step_gap": float(step_gap),
            "dup_chains": float(C - torch.unique(last, dim=0).shape[0]),
            "iterations_per_accept": iterations_per_accept(run.accepts)}
