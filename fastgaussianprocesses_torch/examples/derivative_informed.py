"""Derivative-informed GP: function and gradient observations as tasks
(counterpart of ``examples/derivative_informed.py``)."""

import numpy as np
import torch

from fastgaussianprocesses_torch import FastGPLattice
from fastgaussianprocesses_torch.config import resolve_device
from fastgaussianprocesses_torch.utils.test_functions import gradient


def main(n=1 << 6, iterations=20, device=None):
    d = 2

    def f(x):
        return torch.sin(2 * torch.pi * x[..., 0]) * torch.cos(2 * torch.pi * x[..., 1])

    gf = gradient(f)
    derivs = [np.zeros((1, d), dtype=np.int64)] + [e[None, :] for e in np.eye(d, dtype=np.int64)]
    gp = FastGPLattice(d, num_tasks=3, seed_for_seq=9, derivatives=derivs, alpha=2,
                       device=resolve_device(device))
    xs = gp.get_x_next([n, n, n], task=[0, 1, 2])
    ys = [f(xs[0])] + [gf(xs[j + 1])[:, j] for j in range(d)]
    gp.add_y_next(ys, task=[0, 1, 2])
    gp.fit(iterations=iterations, verbose=0)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(size=(64, d)))
    pm = gp.post_mean(xq, task=[0, 1, 2]).double().cpu().numpy()
    yq = f(xq).numpy()
    gq = gf(xq).numpy()
    rel_f = np.linalg.norm(pm[0] - yq) / np.linalg.norm(yq)
    rel_g = np.linalg.norm(pm[1] - gq[:, 0]) / np.linalg.norm(gq[:, 0])
    print(f"derivative_informed: f rel err {rel_f:.4f}, df/dx0 rel err {rel_g:.4f}")
    assert rel_f < 0.3 and rel_g < 0.5
    return True


if __name__ == "__main__":
    main()
