"""Batched fleets of multitask GPs (counterpart of
``examples/batch_multitask.py``): B members with their own lengthscales and
scale over shared points."""

import numpy as np

from fastgaussianprocesses_torch import FastGPLattice
from fastgaussianprocesses_torch.config import resolve_device


def main(B=3, n=1 << 7, iterations=15, device=None):
    d = 2
    gp = FastGPLattice(d, num_tasks=2, seed_for_seq=7, shape_batch=(B,),
                       shape_lengthscales=(B, d), shape_scale=(B, 1),
                       device=resolve_device(device))
    xs = gp.get_x_next_host([n, n // 2], task=[0, 1])
    y0 = np.stack([(b + 1) * np.sin(2 * np.pi * xs[0][:, 0]) for b in range(B)])
    y1 = np.stack([(b + 1) * np.cos(2 * np.pi * xs[1][:, 1]) for b in range(B)])
    gp.add_y_next([y0, y1], task=[0, 1])
    gp.fit(iterations=iterations, verbose=0)
    xq = np.random.default_rng(0).uniform(size=(32, d))
    pm = gp.post_mean(xq)
    print("batch_multitask: post_mean shape", tuple(pm.shape),
          "(B, tasks, N) =", (B, 2, 32), "; lengthscales", tuple(gp.lengthscales.shape))
    assert tuple(pm.shape) == (B, 2, 32)
    return True


if __name__ == "__main__":
    main()
