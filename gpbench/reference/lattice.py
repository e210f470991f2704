"""Plain reference of the rank-1 lattice GP with a shift-invariant
Bernoulli-polynomial kernel, in plain PyTorch.  It imports nothing of the
program and takes nothing the program made: the design is rebuilt from the
frozen generating vector and shift in the configuration's ``design``.

Model (one task, as configured):

* points, in linear order: ``x_k = frac(k g / n + shift)``, k < n (the
  first n points of the natural-order sequence are the same set, point i
  being ``x_{bitrev(i)}``);
* kernel: ``K(x, z) = scale * prod_j (1 + ls_j c B_{2a}((x_j - z_j) mod 1))``
  with ``c = (-1)^(a+1) (2 pi)^(2a) / (2a)!``;
* the Gram matrix is circulant in linear order, so its eigenvalues are the
  DFT of its first column; each gets ``noise`` added, then the floor
  ``8 eps max|lam|`` with the epsilon of the configuration's dtype;
* MLL loss ``0.5 (sum |Y|^2 / (n lam) + sum log|lam| + n log 2 pi)``,
  ``Y = DFT(y)``; posterior mean ``k_q . K^-1 y`` and variance
  ``K(q, q) - k_q^T K^-1 k_q``, clamped at 0.
"""

import math

import numpy as np
import torch

from .precision import Precision, floor_eps
from .response import response

# Bernoulli polynomials B_{2a}, coefficients from the highest power down
BERNOULLI = {
    2: [1.0, -1.0, 1.0 / 6.0],
    4: [1.0, -2.0, 1.0, 0.0, -1.0 / 30.0],
    6: [1.0, -3.0, 2.5, 0.0, -0.5, 0.0, 1.0 / 42.0],
    8: [1.0, -4.0, 14.0 / 3.0, 0.0, -7.0 / 3.0, 0.0, 2.0 / 3.0, 0.0, -1.0 / 30.0],
}
FLOOR_C = 8.0


def series_coeff(alpha: int) -> float:
    return (-1.0) ** (alpha + 1) * (2 * math.pi) ** (2 * alpha) / math.factorial(2 * alpha)


def bernoulli(order: int, x: torch.Tensor, P: Precision) -> torch.Tensor:
    coeffs = BERNOULLI[order]
    y = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        y = P.r(P.r(y * x) + c)
    return y


class Lattice:
    """The reference model of a lattice configuration on ``device``.

    ``cfg``: the configuration; ``P``: the working precision."""

    def __init__(self, cfg: dict, device, P: Precision = None):
        self.P = P or Precision("float64")
        self.device = torch.device(device)
        design = cfg["design"]
        self.n = int(cfg["n"][0])
        self.d = int(cfg["d"])
        self.alpha = int(cfg["alpha"])
        self.noise = float(cfg["noise"])
        self.eps = floor_eps(cfg)
        g = torch.as_tensor(np.asarray(design["generating_vector"][:self.d], dtype=np.float64),
                            device=self.device)
        shift = torch.as_tensor(np.asarray(design["shift"][:self.d], dtype=np.float64),
                                device=self.device)
        k = torch.arange(self.n, dtype=torch.float64, device=self.device)
        self.x = torch.remainder(k[:, None] / self.n * g[None, :] + shift[None, :], 1.0)
        self.y = response(cfg["response"], self.x)
        self.coeff = series_coeff(self.alpha)
        dt = self.P.dtype
        delta = torch.remainder(self.x - self.x[:1], 1.0).T.contiguous()   # (d, n)
        self.parts = torch.stack([
            self.P.r(self.coeff * bernoulli(2 * self.alpha, self.P.r(delta[j].to(dt)), self.P))
            for j in range(self.d)])
        self.Y = self.P.r(torch.fft.fft(self.P.r(self.y.to(dt))))

    # -- hyperparameters -------------------------------------------------
    @staticmethod
    def values(raw: dict):
        """(scale (C,), lengthscales (C, d)) from raw leaves with a leading
        chain axis (log transforms)."""
        return torch.exp(raw["scale"]).reshape(-1), torch.exp(raw["lengthscales"])

    def eigenvalues(self, scale, ls):
        """Effective eigenvalues (C, n) for (C,) scales and (C, d) lengthscales."""
        P, dt = self.P, self.P.dtype
        scale, ls = P.r(scale.to(dt)), P.r(ls.to(dt))
        k1 = None
        for j in range(self.d):
            f = P.r(1.0 + P.r(ls[:, j, None] * self.parts[j][None, :]))
            k1 = f if k1 is None else P.r(k1 * f)
        k1 = P.r(scale[:, None] * k1)
        lam = P.r(torch.fft.fft(k1).real) + self.noise
        return lam + FLOOR_C * self.eps * lam.abs().amax(-1, keepdim=True)

    def mll_loss(self, raw: dict) -> torch.Tensor:
        """The fit's MLL loss (C,) at raw leaves with a leading chain axis."""
        P = self.P
        lam = self.eigenvalues(*self.values(raw))
        norm = P.r(P.r(self.Y.abs() ** 2)[None, :] / P.r(self.n * lam)).sum(-1)
        logdet = P.r(torch.log(lam.abs())).sum(-1)
        return 0.5 * (norm + logdet + self.n * math.log(2 * math.pi))

    def log_density(self, raw: dict, raw0: dict, prior_std: float) -> torch.Tensor:
        """The hyperposterior's log-density (C,): minus the MLL loss, plus a
        normal prior of ``prior_std`` about ``raw0`` on every sampled leaf."""
        prior = sum(((raw[k] - raw0[k]) ** 2).reshape(raw[k].shape[0], -1).sum(-1) for k in raw)
        return -self.mll_loss(raw) - prior / (2.0 * prior_std ** 2)

    # -- serving ---------------------------------------------------------
    def posterior(self, raw: dict, xq: torch.Tensor, block: int = 16):
        """Posterior mean and variance at (N, d) query points, in blocks of
        ``block`` rows: (N,), (N,) in float64."""
        P, dt = self.P, self.P.dtype
        scale, ls = self.values(raw)
        lam = self.eigenvalues(scale, ls)[0]
        coeffs = P.r(torch.fft.ifft(P.r(self.Y / lam)).real)
        scale, ls = P.r(scale[0].to(dt)), P.r(ls[0].to(dt))
        b0 = bernoulli(2 * self.alpha, torch.zeros((), dtype=dt, device=self.device), P)
        prior = scale * torch.prod(P.r(1.0 + P.r(ls * P.r(self.coeff * b0))))
        means, variances = [], []
        x = self.x.T.contiguous()                                          # (d, n)
        for i in range(0, xq.shape[0], block):
            q = xq[i:i + block].to(torch.float64)
            kq = None
            for j in range(self.d):
                delta = P.r(torch.remainder(q[:, j, None] - x[j][None, :], 1.0).to(dt))
                part = P.r(self.coeff * bernoulli(2 * self.alpha, delta, P))
                f = P.r(1.0 + P.r(ls[j] * part))
                kq = f if kq is None else P.r(kq * f)
            kq = P.r(scale * kq)
            means.append(P.r(kq @ coeffs))
            Kq = P.r(torch.fft.fft(kq))
            quad = P.r(P.r(Kq.abs() ** 2) / P.r(self.n * lam[None, :])).sum(-1)
            variances.append(torch.clamp(P.r(prior - quad), min=0.0))
        return torch.cat(means).to(torch.float64), torch.cat(variances).to(torch.float64)

    def prior_variance(self, raw: dict) -> float:
        scale, ls = self.values(raw)
        return float(scale[0] * torch.prod(1.0 + ls[0] * self.coeff * BERNOULLI[2 * self.alpha][-1]))
