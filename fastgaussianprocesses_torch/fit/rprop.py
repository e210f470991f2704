"""Resilient propagation (Rprop) over dicts of tensors (counterpart of
``fastgaussianprocesses_tpu/fit/rprop.py``).

The sign-based rule of ``torch.optim.Rprop`` (eta 0.5 / 1.2, step sizes in
[1e-6, 50], the gradient zeroed where its sign flips), written as plain
functions so that the state is explicit tensors that a checkpoint stores, with
a per-parameter trainable mask.  Every operation is the JAX package's, so in
float64 the two agree exactly.
"""

from typing import NamedTuple

import torch


class RpropState(NamedTuple):
    step_sizes: dict
    prev_grad: dict


def rprop_init(params: dict, lr: float = 1e-1) -> RpropState:
    return RpropState(step_sizes={k: torch.full_like(p, lr) for k, p in params.items()},
                      prev_grad={k: torch.zeros_like(p) for k, p in params.items()})


def rprop_update(grads: dict, state: RpropState, params: dict, trainable=None,
                 eta_minus: float = 0.5, eta_plus: float = 1.2,
                 step_min: float = 1e-6, step_max: float = 50.0):
    """One Rprop step; returns ``(new_params, new_state)``.  ``trainable``:
    an optional ``{name: bool}``; untrainable parameters and their state are
    passed through unchanged."""
    out_p, out_s, out_g = {}, {}, {}
    for k, p in params.items():
        step, gprev = state.step_sizes[k], state.prev_grad[k]
        if trainable is not None and not trainable[k]:
            out_p[k], out_s[k], out_g[k] = p, step, gprev
            continue
        g = grads[k]
        sign = g * gprev
        new_step = torch.where(sign > 0, torch.clamp(step * eta_plus, max=step_max),
                               torch.where(sign < 0, torch.clamp(step * eta_minus, min=step_min),
                                           step))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        out_p[k] = p - torch.sign(g_eff) * new_step
        out_s[k], out_g[k] = new_step, g_eff
    return out_p, RpropState(step_sizes=out_s, prev_grad=out_g)
