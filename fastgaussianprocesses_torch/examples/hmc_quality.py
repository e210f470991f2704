"""HMC quality on a GP hyperposterior, the default configuration only
(counterpart of ``examples/hmc_quality.py``'s ``default_chees_dense`` row):
ChEES with a dense mass, 6 seeds, 400 warmup and 400 samples, 8 chains, on
``FastGPLattice(3)`` at n = 256.

Prints per seed and overall: the worst split-R-hat, min-ESS per 1000
gradient evaluations by the JAX package's yardstick (``2 L + 2`` gradients an
iteration, L the mean leapfrog count) and by the port's actual count
(``HMCResult.num_grad_evals``: L an iteration, plus one at the start), the
accept rate and the mean leapfrog count; the last line is one JSON object.
The JAX package's figures for this row (CPU, float64; its
``examples/hmc_quality_results.json``): worst R-hat 1.0026, 29.4 min-ESS per
1k gradients.

Run: ``python -m fastgaussianprocesses_torch.examples.hmc_quality`` (on the
card, float64).
"""

import json
import time

import numpy as np
import torch

from fastgaussianprocesses_torch import FastGPLattice
from fastgaussianprocesses_torch.config import resolve_device
from fastgaussianprocesses_torch.fit.hmc import sample_gp_hyperposterior


def main(device=None, dtype=torch.float64, seeds=(11, 12, 13, 14, 15, 16),
         num_samples=400, num_warmup=400, chains=8):
    dev = resolve_device(device)
    gp = FastGPLattice(3, seed_for_seq=7, device=dev, dtype=dtype)
    x = gp.get_x_next_host(256)
    gp.add_y_next(np.sin(2 * np.pi * x[:, 0]) + x.sum(1))
    per_seed = []
    for seed in seeds:
        t0 = time.perf_counter()
        res, diags = sample_gp_hyperposterior(gp, num_samples=num_samples,
                                              num_warmup=num_warmup, num_chains=chains,
                                              seed=seed)
        wall = time.perf_counter() - t0
        min_ess = min(d["ess"] for d in diags.values())
        yardstick = (num_samples + num_warmup) * chains * (2 * res.mean_leapfrog + 2)
        actual = res.num_grad_evals * chains
        row = {"seed": seed, "max_rhat": max(d["rhat"] for d in diags.values()),
               "min_ess": min_ess, "ess_per_1k_grads_yardstick": 1000 * min_ess / yardstick,
               "ess_per_1k_grads_actual": 1000 * min_ess / actual,
               "accept": float(res.accept_rate), "mean_leapfrog": res.mean_leapfrog,
               "wall_s": wall}
        print(json.dumps(row), flush=True)
        per_seed.append(row)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "dtype": str(dtype).replace("torch.", ""),
           "max_rhat_worst_seed": max(r["max_rhat"] for r in per_seed),
           "ess_per_1k_grads_yardstick_mean": float(np.mean(
               [r["ess_per_1k_grads_yardstick"] for r in per_seed])),
           "ess_per_1k_grads_actual_mean": float(np.mean(
               [r["ess_per_1k_grads_actual"] for r in per_seed])),
           "accept_mean": float(np.mean([r["accept"] for r in per_seed])),
           "mean_leapfrog": float(np.mean([r["mean_leapfrog"] for r in per_seed]))}
    print(json.dumps({"hmc_quality": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
