"""HMC over a GP's hyperparameters (counterpart of
``examples/hyperposterior.py``): every chain a row of one solver."""

import numpy as np

from fastgaussianprocesses_torch import FastGPLattice
from fastgaussianprocesses_torch.config import resolve_device
from fastgaussianprocesses_torch.fit.hmc import sample_gp_hyperposterior


def main(n=1 << 8, num_samples=200, num_chains=4, device=None):
    d = 2
    gp = FastGPLattice(d, seed_for_seq=7, device=resolve_device(device))
    x = gp.get_x_next_host(n)
    gp.add_y_next(np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]))
    res, diag = sample_gp_hyperposterior(gp, num_samples=num_samples,
                                         num_warmup=num_samples,
                                         num_chains=num_chains, seed=0)
    print("accept rate %.2f" % float(res.accept_rate))
    for k, v in diag.items():
        print(f"  {k}: rhat={v['rhat']:.3f} ess={v['ess']:.0f}")
    assert float(res.accept_rate) > 0.2
    return True


if __name__ == "__main__":
    main()
