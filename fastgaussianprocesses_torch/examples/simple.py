"""Single-task GP regression end to end with the three models (counterpart
of ``examples/simple.py``): fit, posterior mean, credible and cubature
intervals on Ackley."""

import numpy as np
import torch

from fastgaussianprocesses_torch import FastGPDigitalNetB2, FastGPLattice, StandardGP
from fastgaussianprocesses_torch.config import resolve_device
from fastgaussianprocesses_torch.utils.test_functions import ackley


def main(n=1 << 10, d=2, iterations=30, device=None):
    dev = resolve_device(device)
    for name, cls in [("lattice", FastGPLattice), ("dnb2", FastGPDigitalNetB2),
                      ("standard", StandardGP)]:
        nn = min(n, 1 << 7) if name == "standard" else n
        gp = cls(d, seed_for_seq=7, device=dev)
        x = gp.get_x_next(nn)
        gp.add_y_next(ackley(x))
        xq = np.random.default_rng(17).uniform(size=(128, d))
        yq = ackley(torch.as_tensor(xq)).numpy()

        def rel():
            pm = gp.post_mean(xq).double().cpu().numpy()
            return np.linalg.norm(yq - pm) / np.linalg.norm(yq)

        r0 = rel()
        gp.fit(iterations=iterations, verbose=0)
        r1 = rel()
        gp.post_ci(xq, confidence=0.99)
        pcm, pcv, q, clo, chi = gp.post_cubature_ci(confidence=0.99)
        print(f"{name:9s} rel err {r0:.4f} -> {r1:.4f}; cubature mean "
              f"{float(pcm):.4f} in [{float(clo):.4f}, {float(chi):.4f}]")
        assert np.isfinite(r1)
    return True


if __name__ == "__main__":
    main()
