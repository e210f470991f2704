"""HMC quality over many seeds, to tell a sampler's stick rate from the luck
of a few seeds.  Each stream runs the configuration of
``examples/hmc_quality.py``'s default row (``FastGPLattice(3,
seed_for_seq=7)``, n = 256, y = sin(2 pi x0) + sum x, float64 on the CPU,
ChEES with a dense mass, 8 chains, 400 warmup and 400 samples):

- ``port``: the port's ``sample_gp_hyperposterior`` on its own draws (a CPU
  ``torch.Generator`` a step);
- ``port_pcg64``: the port's sampler on numpy PCG64 draws, seeded from
  ``(seed, t)`` as the port's own are (a second, independent stream);
- ``port_jax_draws``: the port's sampler on the JAX package's draws (its
  threefry key schedule);
- ``jax``: the JAX package's ``sample_gp_hyperposterior``.

A single seed's R-hat is a chaotic outcome (two runs a few ulps apart end
in different places), so the 6 seeds of the quality protocol say little
about the rate at which a chain sticks.  Run from the repo root::

    python tools/hmc_seed_sweep.py FIRST_SEED LAST_SEED [STREAM ...]

(all streams by default).  It prints one JSON line a seed and stream, then
``{"summary": ...}``: per stream the seeds, the count with a worst R-hat
above 1.1 and above 1.01, the worst, and the mean and median min-ESS per
1000 gradients by the ``2 L + 2`` yardstick.  ``--summarize FILE ...``
prints the summary of the JSON lines in earlier outputs instead.
"""

import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

STREAMS = ("port", "port_pcg64", "port_jax_draws", "jax")


def _models():
    import jax
    import jax.numpy as jnp
    import torch

    import fastgaussianprocesses_torch as ft
    import fastgaussianprocesses_tpu as fj
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jg = fj.FastGPLattice(3, seed_for_seq=7)
    x = np.asarray(jg.get_x_next(256))
    y = np.sin(2 * np.pi * x[:, 0]) + x.sum(1)
    jg.add_y_next(jnp.asarray(y))
    tg = ft.FastGPLattice(3, seed_for_seq=7, device="cpu")
    tg.get_x_next(256)
    tg.add_y_next(torch.from_numpy(y))
    return jg, tg


def pcg64_draws(seed, num_chains, dim, traj):
    """Step ``t``'s draws from numpy's PCG64 seeded with ``(seed, t + 1)``,
    in the port's ``_draw_fn`` form (float64; ``traj`` as in ``_draws``)."""
    import torch

    def draw(t):
        g = np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), int(t) + 1])))
        if t < 0:
            return {"init": torch.from_numpy(g.standard_normal((num_chains, dim)))}
        z = torch.from_numpy(g.standard_normal((num_chains, dim)))
        if traj == "uniform":
            tr = torch.tensor(g.random())
        elif traj is None:
            tr = None
        else:
            tr = int(g.integers(traj[0], traj[1] + 1))
        return {"z": z, "traj": tr, "accept_u": torch.from_numpy(g.random(num_chains))}
    return draw


def run_seed(stream, seed, models, num_samples=400, num_warmup=400, chains=8):
    """One seed of one stream: the worst split-R-hat, min-ESS per 1000
    gradients by the ``2 L + 2`` yardstick, acceptance, mean leapfrog."""
    from fastgaussianprocesses_torch.fit import hmc as th
    from fastgaussianprocesses_tpu.fit import hmc as jh
    jg, tg = models
    t0 = time.perf_counter()
    kw = dict(num_samples=num_samples, num_warmup=num_warmup, num_chains=chains, seed=seed)
    if stream == "jax":
        res, diags = jh.sample_gp_hyperposterior(jg, **kw)
    elif stream == "port":
        res, diags = th.sample_gp_hyperposterior(tg, **kw)
    else:
        from test_torch_hmc import jax_draws
        make = {"port_pcg64": pcg64_draws, "port_jax_draws": jax_draws}[stream]
        hmc = th.hmc
        dim = sum(int(np.prod(v.shape)) for k, v in tg._raw_dict().items()
                  if k in ("scale", "lengthscales"))

        def with_draws(*a, **k):
            return hmc(*a, _draw_fn=make(seed, chains, dim, "uniform"), **k)
        th.hmc = with_draws
        try:
            res, diags = th.sample_gp_hyperposterior(tg, **kw)
        finally:
            th.hmc = hmc
    grads = (num_samples + num_warmup) * chains * (2 * res.mean_leapfrog + 2)
    return {"stream": stream, "seed": seed, "max_rhat": max(d["rhat"] for d in diags.values()),
            "ess_per_1k_grads": 1000 * min(d["ess"] for d in diags.values()) / grads,
            "accept": float(res.accept_rate), "mean_leapfrog": float(res.mean_leapfrog),
            "wall_s": time.perf_counter() - t0}


def summary(rows):
    """Per stream: seeds, how many have a worst R-hat above 1.1 and 1.01,
    the worst, and the mean and median min-ESS per 1000 gradients."""
    out = {}
    for s in sorted({r["stream"] for r in rows}):
        rs = [r for r in rows if r["stream"] == s]
        ess = [r["ess_per_1k_grads"] for r in rs]
        out[s] = {"seeds": len(rs), "rhat_above_1.1": sum(r["max_rhat"] > 1.1 for r in rs),
                  "rhat_above_1.01": sum(r["max_rhat"] > 1.01 for r in rs),
                  "worst_rhat": max(r["max_rhat"] for r in rs),
                  "ess_per_1k_mean": float(np.mean(ess)),
                  "ess_per_1k_median": float(np.median(ess))}
    return out


if __name__ == "__main__":
    if sys.argv[1] == "--summarize":
        rows = []
        for path in sys.argv[2:]:
            with open(path) as f:
                rows += [r for r in map(json.loads, f) if "stream" in r]
        print(json.dumps({"summary": summary(rows)}))
        sys.exit(0)
    first, last = int(sys.argv[1]), int(sys.argv[2])
    streams = sys.argv[3:] or STREAMS
    models = _models()
    rows = []
    for seed in range(first, last + 1):
        for s in streams:
            rows.append(run_seed(s, seed, models))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
