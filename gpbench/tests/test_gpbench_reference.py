"""The plain references against dense float64 GPs at small n, the weighted
Walsh series against its definition, and the port at small n on the CPU."""

import itertools
import json
import math

import numpy as np
import pytest
import torch

from gpbench.reference.digital_net import DigitalNetMultitask, omega
from gpbench.reference.lattice import Lattice
from gpbench.reference.precision import Precision
from gpbench.reference.response import response

from .conftest import GPBENCH


def _cfg(name, **kw):
    cfg = json.loads((GPBENCH / "configs" / f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


def _raw(cfg, rng):
    d = cfg["d"]
    raw = {"scale": torch.tensor([[math.log(rng.uniform(0.5, 2))]], dtype=torch.float64),
           "lengthscales": torch.log(torch.tensor(rng.uniform(0.5, 2, (1, d))))}
    if cfg.get("num_tasks"):
        T = cfg["num_tasks"]
        raw = {k: v[0] for k, v in raw.items()}
        raw["factor_task_kernel"] = torch.tensor(rng.uniform(0.5, 1.5, (T, 1)))
        raw["noise_task_kernel"] = torch.log(torch.tensor(rng.uniform(0.5, 2, T)))
    return raw


def _dense_mll(K, y):
    L = torch.linalg.cholesky(K)
    a = torch.cholesky_solve(y[:, None], L)[:, 0]
    return 0.5 * (y @ a + 2 * torch.log(torch.diagonal(L)).sum() + len(y) * math.log(2 * math.pi))


def test_lattice_against_dense():
    cfg = _cfg("lattice_d8_n20", d=3, n=[256], dtype="float64", noise=1e-3)
    ref = Lattice(cfg, "cpu")
    raw = _raw(cfg, np.random.default_rng(0))
    sc, ls = ref.values(raw)

    def kern(a, b):
        dd = torch.remainder(a[:, None, :] - b[None, :, :], 1.0)
        return sc[0] * torch.prod(1 + ls[0] * ref.coeff * (dd ** 4 - 2 * dd ** 3 + dd ** 2
                                                           - 1 / 30), -1)
    K = kern(ref.x, ref.x) + 1e-3 * torch.eye(256, dtype=torch.float64)
    # the model's eigenvalue floor, 8 eps max|lam|, at float64's epsilon here
    K += 8 * ref.eps * torch.linalg.eigvalsh(K).max() * torch.eye(256, dtype=torch.float64)
    # the dense solve's own rounding at a condition number of ~1e7 is ~1e-9
    assert float(ref.mll_loss(raw)[0]) == pytest.approx(float(_dense_mll(K, ref.y)), rel=1e-9)
    xq = torch.rand(6, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    m, v = ref.posterior(raw, xq, block=4)
    kq = kern(xq, ref.x)
    Kinv = torch.linalg.inv(K)
    want_v = torch.stack([kern(q[None], q[None])[0, 0] for q in xq]) - ((kq @ Kinv) * kq).sum(1)
    assert torch.allclose(m, kq @ Kinv @ ref.y, atol=1e-8)
    assert torch.allclose(v, want_v, atol=1e-8)


def test_omega_against_the_walsh_series():
    """w_a(x) = sum over nonempty sets A of digit positions of w(A) prod_a
    (-1)^{x_a}, w(A) the product of 2^(1 - 2a) over A's alpha largest
    positions; positions past t hold zero digits.  Truncated at 16 positions
    (the tail is below 4^-16)."""
    t, P = 5, 16
    xs = torch.tensor([0, 1, 2, 5, 16, 31, 22], dtype=torch.int64)
    for alpha in (1, 2):
        want = []
        for x in xs.tolist():
            digits = [(x >> (t - a)) & 1 if a <= t else 0 for a in range(1, P + 1)]
            total = 0.0
            for size in range(1, P + 1):
                for A in itertools.combinations(range(1, P + 1), size):
                    w = math.prod(2.0 ** (1 - 2 * a) for a in A[-alpha:])
                    total += w * (-1) ** sum(digits[a - 1] for a in A)
            want.append(total)
        assert torch.allclose(omega(xs, t, alpha), torch.tensor(want, dtype=torch.float64),
                              rtol=0, atol=2.0 ** -15 if alpha == 1 else 4.0 ** -15)


def test_multitask_against_dense():
    cfg = _cfg("mt_dnb2", d=3, n=[64, 32, 16], dtype="float64", noise=1e-4)
    ref = DigitalNetMultitask(cfg, "cpu")
    raw = _raw(cfg, np.random.default_rng(2))
    sc, ls, F, v = ref.values(raw)
    B = F @ F.T + torch.diag(v)
    ns, off = ref.ns, np.concatenate([[0], np.cumsum(ref.ns)])
    N = off[-1]
    K = torch.zeros(N, N, dtype=torch.float64)
    for a in range(3):
        for b in range(3):
            x = ref.xb[a][:, None, :] ^ ref.xb[b][None, :, :]
            K[off[a]:off[a + 1], off[b]:off[b + 1]] = B[a, b] * sc * torch.prod(
                1 + ls * omega(x, 30, 2), -1)
        K[off[a]:off[a + 1], off[a]:off[a + 1]] += 1e-4 * B[a, a] * torch.eye(ns[a])
    assert float(ref.mll_loss(raw)) == pytest.approx(float(_dense_mll(K, torch.cat(ref.y))),
                                                     rel=1e-11)


def test_references_equal_the_port_at_small_n():
    """The port on the CPU in float64 (its floor at float64's epsilon, as the
    references take it from the configuration's dtype)."""
    ft = pytest.importorskip("fastgaussianprocesses_torch")
    cfg = _cfg("lattice_d8_n20", d=3, n=[256], dtype="float64")
    ref = Lattice(cfg, "cpu")
    raw = _raw(cfg, np.random.default_rng(3))
    sc, ls = ref.values(raw)
    gp = ft.FastGPLattice(3, seed_for_seq=7, alpha=2, noise=cfg["noise"], device="cpu",
                          scale=float(sc[0]), lengthscales=ls[0].numpy())
    gp.add_y_next(response(cfg["response"], torch.as_tensor(gp.get_x_next_host(256))))
    xq = torch.rand(5, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    pm, pv = gp.post_mean_var(xq)
    m, v = ref.posterior(raw, xq)
    assert torch.allclose(pm, m, rtol=0, atol=1e-8 * float(m.abs().max()))
    assert torch.allclose(pv, v, rtol=0, atol=1e-10 * ref.prior_variance(raw))
    loss = -gp.fit(iterations=0, store_loss_hist=True, verbose=0)["loss_hist"][0]
    assert loss == pytest.approx(float(ref.mll_loss(raw)[0]), rel=1e-12)

    cfg = _cfg("mt_dnb2", d=3, n=[64, 32, 16], dtype="float64")
    ref = DigitalNetMultitask(cfg, "cpu")
    raw = _raw(cfg, np.random.default_rng(5))
    sc, ls, F, v = ref.values(raw)
    gp = ft.FastGPDigitalNetB2(3, num_tasks=3, seed_for_seq=7, alpha=2, noise=cfg["noise"],
                               device="cpu", scale=float(sc), lengthscales=ls.numpy(),
                               factor_task_kernel=F.numpy(), noise_task_kernel=v.numpy())
    xs = gp.get_x_next_host(ref.ns, task=[0, 1, 2])
    for l, x in enumerate(xs):
        assert np.array_equal((x * 2.0 ** 30).astype(np.int64), ref.xb[l].numpy())
    gp.add_y_next([response(cfg["response"], torch.as_tensor(x), task=l)
                   for l, x in enumerate(xs)], task=[0, 1, 2])
    loss = -gp.fit(iterations=0, store_loss_hist=True, verbose=0)["loss_hist"][0]
    assert loss == pytest.approx(float(ref.mll_loss(raw)), rel=1e-12)


def test_bfloat16_control_rounds():
    cfg = _cfg("lattice_d8_n20", d=3, n=[256], dtype="float32")
    raw = _raw(cfg, np.random.default_rng(6))
    hi = float(Lattice(cfg, "cpu").mll_loss(raw)[0])
    lo = float(Lattice(cfg, "cpu", Precision("bfloat16")).mll_loss(raw)[0])
    assert 1e-6 < abs(lo - hi) / abs(hi)
    with pytest.raises(ValueError):
        Precision("float16")
