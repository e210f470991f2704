"""Multi-fidelity multitask GP (counterpart of ``examples/multitask.py``):
three fidelities of Ackley at unequal sample counts, the exact one predicted."""

import numpy as np
import torch

from fastgaussianprocesses_torch import FastGPLattice
from fastgaussianprocesses_torch.config import resolve_device
from fastgaussianprocesses_torch.utils.test_functions import ackley


def main(n_hi=1 << 7, iterations=25, device=None):
    d = 2
    # three fidelities of Ackley: coarse, medium, exact; unequal sample counts
    fns = [lambda x: ackley(x, a=18.0), lambda x: ackley(x, a=19.5), ackley]
    ns = [4 * n_hi, 2 * n_hi, n_hi]
    gp = FastGPLattice(d, num_tasks=3, seed_for_seq=7, device=resolve_device(device))
    xs = gp.get_x_next(ns, task=[0, 1, 2])
    gp.add_y_next([f(x) for f, x in zip(fns, xs)], task=[0, 1, 2])
    gp.fit(iterations=iterations, verbose=0)
    xq = np.random.default_rng(5).uniform(size=(256, d))
    yq = ackley(torch.as_tensor(xq)).numpy()
    pm = gp.post_mean(xq, task=2).double().cpu().numpy()
    rel = np.linalg.norm(yq - pm) / np.linalg.norm(yq)
    pcov = gp.post_cubature_cov().double().cpu().numpy()
    print(f"multitask: high-fidelity rel err {rel:.4f} with n={n_hi} exact samples; "
          f"task cubature cov diag {np.diag(pcov).round(6)}")
    assert rel < 0.5
    return True


if __name__ == "__main__":
    main()
