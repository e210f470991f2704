"""The system under test as a configuration states it: the hyperparameters
drawn from the seed, the model built through the port's public API, and
the observations handed to it."""

import numpy as np
import torch

from gpbench.reference.response import response

TRANSFORMS = {"log": np.log, "identity": lambda v: v}


def draw_hyperparameters(cfg, seed):
    """``{name: value}`` drawn from the seed by the configuration's
    ``hyperparameters``: each ``{"dist": "loguniform" | "uniform", "range":
    [lo, hi], "shape": [...], "transform": "log" | "identity"}``, with
    ``"d"`` in a shape standing for the dimension."""
    rng = np.random.default_rng([int(seed), 1])
    out = {}
    for name, spec in cfg["hyperparameters"].items():
        shape = tuple(int(cfg["d"]) if s == "d" else int(s) for s in spec["shape"])
        lo, hi = spec["range"]
        if spec["dist"] == "loguniform":
            v = np.exp(rng.uniform(np.log(lo), np.log(hi), size=shape))
        else:
            v = rng.uniform(lo, hi, size=shape)
        out[name] = v
    return out


def raw_values(cfg, values, device):
    """The raw (transformed) float64 leaves of drawn ``values``, with a
    leading axis of 1: the reference's parameters."""
    return {k: torch.as_tensor(TRANSFORMS[cfg["hyperparameters"][k]["transform"]](v),
                               dtype=torch.float64, device=device)[None]
            for k, v in values.items()}


def build(cfg, values, device):
    """The configured model with ``values`` as its hyperparameters and the
    configuration's observations at its points."""
    import fastgaussianprocesses_torch as ft

    cls = getattr(ft, cfg["model"])
    kw = dict(seed_for_seq=cfg["seed_for_seq"], alpha=cfg["alpha"], noise=cfg["noise"],
              dtype=getattr(torch, cfg["dtype"]), device=device)
    if cfg.get("num_tasks"):
        kw["num_tasks"] = int(cfg["num_tasks"])
    gp = cls(int(cfg["d"]), **kw, **values)
    ns = [int(v) for v in cfg["n"]]
    if not cfg.get("num_tasks"):
        x = torch.as_tensor(gp.get_x_next_host(ns[0]), device=device)
        gp.add_y_next(response(cfg["response"], x))
    else:
        tasks = list(range(len(ns)))
        xs = gp.get_x_next_host(ns, task=tasks)
        gp.add_y_next([response(cfg["response"], torch.as_tensor(x, device=device), task=l)
                       for l, x in zip(tasks, xs)], task=tasks)
    return gp


def worst(values):
    """The largest of ``values``, or inf where any is not a number: a gap
    that cannot be computed fails."""
    values = [float(v) for v in values]
    return float("inf") if any(v != v for v in values) else max(values)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
