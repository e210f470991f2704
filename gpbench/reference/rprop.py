"""Resilient propagation as the configurations state it (``torch.optim.Rprop``'s
rule: eta 0.5 / 1.2, step sizes in [1e-6, 50], the gradient zeroed where its
sign flips, initial step ``lr``), and a plain fit of a few steps of it."""

from typing import NamedTuple

import torch


class Fit(NamedTuple):
    losses: list        # the loss before each step
    first_grad: dict    # the first step's gradient
    after_first: dict   # the leaves after the first ``first`` steps
    best: dict          # the leaves before the step of the least loss (the first such)


def rprop_fit(loss_fn, raw0: dict, steps: int, first: int = 1, lr: float = 0.1) -> Fit:
    """``steps`` Rprop steps of ``loss_fn`` (a scalar function of the leaves)
    from ``raw0``."""
    raw = {k: v.detach().clone() for k, v in raw0.items()}
    step = {k: torch.full_like(v, lr) for k, v in raw.items()}
    prev = {k: torch.zeros_like(v) for k, v in raw.items()}
    losses, first_grad, after_first, best = [], None, None, None
    for i in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
        loss = loss_fn(leaves)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach() for k, g in grads.items()}
        if losses[-1] < min(losses[:-1], default=float("inf")):
            best = dict(raw)
        with torch.no_grad():
            for k, g in grads.items():
                sign = g * prev[k]
                step[k] = torch.where(sign > 0, torch.clamp(step[k] * 1.2, max=50.0),
                                      torch.where(sign < 0, torch.clamp(step[k] * 0.5, min=1e-6),
                                                  step[k]))
                g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
                raw[k] = raw[k] - torch.sign(g_eff) * step[k]
                prev[k] = g_eff
        if i + 1 == first:
            after_first = dict(raw)
    return Fit(losses, first_grad, after_first, best)
