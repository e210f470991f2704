"""The benchmark's observations: the functions that the configurations'
``response`` names, evaluated on the design points.  The benchmark hands
the same values to the program and to the reference."""

import math

import torch


def sin_cos_sum(x: torch.Tensor, task: int, task_term: float) -> torch.Tensor:
    """``sin(2 pi x0) cos(2 pi x1) + sum_j x_j`` (the flagship's function),
    plus ``task_term * task * cos(2 pi x2)`` for task ``task`` of a
    multi-fidelity model."""
    y = torch.sin(2 * math.pi * x[:, 0]) * torch.cos(2 * math.pi * x[:, 1]) + x.sum(1)
    if task:
        y = y + task_term * task * torch.cos(2 * math.pi * x[:, 2])
    return y


RESPONSES = {"sin_cos_sum": sin_cos_sum}


def response(spec: dict, x: torch.Tensor, task: int = 0) -> torch.Tensor:
    """The observations of ``spec`` (a configuration's ``response``) at the
    float64 points ``x``, (n, d) -> (n,)."""
    return RESPONSES[spec["kind"]](x, task, float(spec.get("task_term", 0.0)))
