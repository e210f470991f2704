"""Plain reference of the multitask GP on a base-2 digital net (Sobol')
with the digitally-shift-invariant weighted-Walsh kernel, in plain PyTorch.
It imports nothing of the program and takes nothing the program made: the
net is rebuilt from the frozen direction numbers and each task's digital
shift in the configuration's ``design``.

Model (T tasks at n_0 >= n_1 >= ... points, each a power of two):

* points: task l's point i is ``P_i XOR s_l`` in t-bit integers, where
  ``P_i`` XORs the generating-matrix columns of the set bits of i, so
  ``P_i XOR P_j = P_(i XOR j)``;
* kernel: ``K(x, z) = scale * prod_j (1 + ls_j w_a(x_j XOR z_j))`` with the
  weighted Walsh series ``w_a`` (:func:`omega`), and the task Gram
  ``B = F F^T + diag(v)``: the covariance of task l's point i and task k's
  point j is ``B_lk K(...)``, plus ``B_ll noise`` on the diagonal;
* in the Walsh basis (``H[k, i] = (-1)^popcount(k & i)``) the block of tasks
  a <= b is ``sqrt(n_b / n_a) (H f_ab)[k]`` at frequencies (k, k mod n_b),
  ``f_ab[m] = K(x^a_m, x^b_0)``, so the system splits into n_min blocks of
  M = sum_l n_l / n_min rows, one a residue k mod n_min; each task's
  diagonal eigenvalues get the floor ``8 eps max|lam|`` and each block the
  ridge ``8 eps max|diag|`` with the epsilon of the configuration's dtype;
* MLL loss ``0.5 (sum_rho Y^T theta^-1 Y + sum_rho log|det theta| + N log 2 pi)``
  with ``Y`` the orthonormal Walsh transforms of the observations.
"""

import math

import numpy as np
import torch

from .precision import Precision, floor_eps
from .response import response

FLOOR_C = 8.0


def omega(x: torch.Tensor, t: int, alpha: int, dtype=torch.float64) -> torch.Tensor:
    """The weighted Walsh series ``w_a(x) = sum_{k >= 1} r_a(k) wal_k(x)`` at
    t-bit integers ``x``, in closed form: with ``b*`` the index of x's
    leading one bit (from the least significant), ``z = 2^-(t - b*)`` (0 at
    x = 0) and ``s1 = sum over set bits b of 4^-(t - b)``,

        w_1 = 1 - 3 z,
        w_2 = 16/21 - 8 s1 + 12 z s1 - (38/7) z^3.
    """
    x = x.to(torch.int64)
    lead = torch.full_like(x, -1)
    s1 = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for b in range(t):
        bit = (x >> b) & 1
        lead = torch.where(bit == 1, torch.full_like(lead, b), lead)
        s1 = s1 + bit.to(torch.float64) * 4.0 ** -(t - b)
    z = torch.where(lead >= 0, torch.exp2((lead - t).to(torch.float64)),
                    torch.zeros_like(s1))
    if alpha == 1:
        out = 1.0 - 3.0 * z
    elif alpha == 2:
        out = 16.0 / 21.0 - 8.0 * s1 + 12.0 * z * s1 - (38.0 / 7.0) * z ** 3
    else:
        raise ValueError(f"the reference has the weighted Walsh series of orders 1 and 2, "
                         f"not {alpha}")
    return out.to(dtype)


def fwht(v: torch.Tensor, P: Precision) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform of the last axis in natural
    (Sylvester) order, by radix-2 butterflies."""
    n = v.shape[-1]
    lead = v.shape[:-1]
    h = 1
    while h < n:
        w = v.reshape(lead + (n // (2 * h), 2, h))
        a, b = w[..., 0, :], w[..., 1, :]
        v = P.r(torch.stack([a + b, a - b], -2)).reshape(lead + (n,))
        h *= 2
    return v


def net(directions, n: int, device) -> torch.Tensor:
    """The unshifted base-2 net, (n, d) t-bit integers in natural order."""
    cols = torch.as_tensor(np.asarray(directions, dtype=np.int64), device=device)  # (d, m)
    pts = torch.zeros((1, cols.shape[0]), dtype=torch.int64, device=device)
    k = 0
    while pts.shape[0] < n:
        pts = torch.cat([pts, pts ^ cols[:, k][None, :]], 0)
        k += 1
    return pts[:n]


class DigitalNetMultitask:
    """The reference model of a (multitask) digital-net configuration."""

    def __init__(self, cfg: dict, device, P: Precision = None):
        self.P = P or Precision("float64")
        self.device = torch.device(device)
        design = cfg["design"]
        self.t = int(design["t"])
        self.d = int(cfg["d"])
        self.alpha = int(cfg["alpha"])
        self.noise = float(cfg["noise"])
        self.eps = floor_eps(cfg)
        self.ns = [int(v) for v in cfg["n"]]
        if any(a < b for a, b in zip(self.ns, self.ns[1:])):
            raise ValueError("the reference takes tasks in descending n")
        self.T = len(self.ns)
        self.n_min = self.ns[-1]
        self.r = [nl // self.n_min for nl in self.ns]
        base = net([row[:self.t] for row in design["directions"][:self.d]], self.ns[0],
                   self.device)
        shifts = torch.as_tensor(np.asarray(design["shifts"], dtype=np.int64)[:, :self.d],
                                 device=self.device)
        self.xb = [base[:nl] ^ shifts[l][None, :] for l, nl in enumerate(self.ns)]
        self.y = [response(cfg["response"], xb.to(torch.float64) * 2.0 ** -self.t, task=l)
                  for l, xb in enumerate(self.xb)]
        dt = self.P.dtype
        # hyperparameter-independent series parts of each pair's first column
        self.parts = {}
        for a in range(self.T):
            for b in range(a, self.T):
                delta = self.xb[a] ^ self.xb[b][:1]
                self.parts[(a, b)] = torch.stack([
                    self.P.r(omega(delta[:, j], self.t, self.alpha, dt)) for j in range(self.d)])
        self.Y = torch.cat([
            self.P.r(fwht(self.P.r(y.to(dt)), self.P) / math.sqrt(nl)).reshape(rl, self.n_min)
            for y, nl, rl in zip(self.y, self.ns, self.r)], 0).T.contiguous()   # (n_min, M)

    def values(self, raw: dict):
        return (torch.exp(raw["scale"]).reshape(()), torch.exp(raw["lengthscales"]).reshape(-1),
                raw["factor_task_kernel"], torch.exp(raw["noise_task_kernel"]))

    def blocks(self, raw: dict) -> torch.Tensor:
        """The (n_min, M, M) residue blocks, floored and ridged."""
        P, dt = self.P, self.P.dtype
        scale, ls, F, v = (P.r(t.to(dt)) for t in self.values(raw))
        B = P.r(F @ F.T) + torch.diag(v)
        lam = {}
        for (a, b), parts in self.parts.items():
            f = None
            for j in range(self.d):
                g = P.r(1.0 + P.r(ls[j] * parts[j]))
                f = g if f is None else P.r(f * g)
            lab = P.r(fwht(P.r(scale * f), P) * math.sqrt(self.ns[b] / self.ns[a]))
            if a == b:
                lab = P.r(P.r(lab + self.noise) * B[a, a])
                lab = lab + FLOOR_C * self.eps * lab.abs().amax()
            else:
                lab = P.r(lab * B[a, b])
            lam[(a, b)] = lab.reshape(self.r[a], self.n_min)
        M = sum(self.r)
        offs = np.concatenate([[0], np.cumsum(self.r)])
        zero = torch.zeros(self.n_min, dtype=dt, device=self.device)
        ent = [[zero] * M for _ in range(M)]
        for (a, b), lab in lam.items():
            for j in range(self.r[a]):
                i0, i1 = offs[a] + j, offs[b] + j % self.r[b]
                ent[i0][i1] = lab[j]
                ent[i1][i0] = lab[j]
        theta = torch.stack([torch.stack(row, -1) for row in ent], -2)
        dmag = torch.diagonal(theta, dim1=-2, dim2=-1).abs().amax(-1)
        return theta + (FLOOR_C * self.eps * dmag)[:, None, None] * torch.eye(
            M, dtype=dt, device=self.device)

    def mll_loss(self, raw: dict) -> torch.Tensor:
        P = self.P
        theta = self.blocks(raw)
        if P.name == "float64":
            z = torch.linalg.solve(theta, self.Y[..., None])[..., 0]
            logdet = torch.linalg.slogdet(theta).logabsdet
        else:
            # no bfloat16 factorization: the solve in float32 on the rounded
            # blocks, its result rounded
            z = P.r(torch.linalg.solve(theta, self.Y[..., None])[..., 0])
            logdet = P.r(torch.linalg.slogdet(theta).logabsdet)
        norm = P.r(self.Y * z).sum()
        N = float(sum(self.ns))
        return 0.5 * (norm + logdet.sum() + N * math.log(2 * math.pi))
