"""Checkpoint / resume for GP models and HMC runs (counterpart of
``fastgaussianprocesses_tpu/utils/checkpoint.py``, with its ``.npz`` keys).

A model's dynamic state (raw hyperparameters, per-task observations, sample
counts and the sequence randomizations that regenerate identical points)
round-trips through one ``.npz`` file: ``n``, ``raw_<name>``, ``y_<task>``,
``seq_shift_<task>``, ``seq_columns_<task>``, ``seq_gen_vec_<task>``.  An HMC
resume token is ``c<i>`` for each carry entry, ``next_t`` and ``ncarry``.  A
file written by either package loads into the other.  Static configuration
(dimensions, kernel class, derivative multi-indices) stays in the
constructor call: build an identically configured model, then
:func:`load_state` into it.
"""

import numpy as np
import torch


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_hmc_state(state, path: str):
    """Write an HMC resume token (``HMCResult.state``) to ``path`` (.npz)."""
    carry, next_t = state
    arrays = {f"c{i}": _host(v) for i, v in enumerate(carry)}
    arrays["next_t"] = np.asarray(next_t)
    arrays["ncarry"] = np.asarray(len(carry))
    np.savez(path, **arrays)


def load_hmc_state(path: str):
    """An HMC resume token saved by :func:`save_hmc_state` (either package's),
    its carry as CPU tensors; ``hmc(init_state=...)`` moves them to the
    sampler's device."""
    with np.load(path) as data:
        ncarry = int(data["ncarry"])
        carry = tuple(torch.as_tensor(data[f"c{i}"]) for i in range(ncarry))
        return carry, int(data["next_t"])


def save_state(model, path: str):
    """Write the model's dynamic state to ``path`` (.npz)."""
    arrays = {"n": np.asarray(model.n)}
    for k, p in model.params.items():
        arrays[f"raw_{k}"] = _host(p.raw)
    for l in range(model.num_tasks):
        arrays[f"y_{l}"] = _host(model._y[l])
    for l, seq in enumerate(model.seqs):
        for attr in ("shift", "columns", "gen_vec"):
            if hasattr(seq, attr):
                arrays[f"seq_{attr}_{l}"] = np.asarray(getattr(seq, attr))
    np.savez(path, **arrays)


def load_state(model, path: str):
    """Restore state saved by :func:`save_state` into a model built with the
    same constructor configuration; every cache the model keeps (points,
    first-column parts, transformed observations, solvers, coefficients,
    query columns) is cleared, since it may belong to the old randomization
    or observations."""
    with np.load(path) as data:
        n = np.asarray(data["n"], dtype=np.int64)
        if n.shape != (model.num_tasks,):
            raise ValueError(f"state has {n.shape} sample counts for {model.num_tasks} tasks")
        model._set_raw({k: torch.as_tensor(data[f"raw_{k}"], dtype=p.raw.dtype,
                                           device=p.raw.device)
                        for k, p in model.params.items()})
        for l, seq in enumerate(model.seqs):
            if f"seq_shift_{l}" in data and hasattr(seq, "shift"):
                seq.shift = data[f"seq_shift_{l}"]
            if f"seq_columns_{l}" in data and hasattr(seq, "columns"):
                seq.columns = data[f"seq_columns_{l}"]
                # the doubling buffer restarts in the net's own digit dtype
                seq._xb = np.zeros((1, seq.d), dtype=seq.columns.dtype)
            if f"seq_gen_vec_{l}" in data and hasattr(seq, "gen_vec"):
                seq.gen_vec = data[f"seq_gen_vec_{l}"]
        model._y = [torch.as_tensor(data[f"y_{l}"], device=model.device).to(model.dtype)
                    for l in range(model.num_tasks)]
    model._x_cache = [None] * model.num_tasks
    model._xb_cache = [None] * model.num_tasks
    # _k1parts_cache, _k1parts_lam_cache, _ytilde_cache, _ytilde_half_cache,
    # _ytilde_perm_cache, _solver_cache (fast models), _solver_cache
    # (StandardGP), _xbq_cache (every model)
    for name, cache in vars(model).items():
        if name.endswith("_cache") and isinstance(cache, dict):
            cache.clear()
    model.n = n
    model._coeffs_cache = None
    return model
