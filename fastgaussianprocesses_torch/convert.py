"""Carry hyperparameters over from a JAX-package model::

    raw = {k: np.asarray(v) for k, v in jax_gp._raw_dict().items()}
    trainable = {k: p.trainable for k, p in jax_gp.params.items()}
    load_jax_params(torch_gp, raw, trainable)

Both packages then compute the same posterior on the same data, and their
``fit`` trains the same parameters.  The raw values are the parameters
before their transforms (``log`` of scale, lengthscales and noise by
default), so the two models must use the same transforms, which the
defaults do.  Multitask and fleet shapes carry over as they are (a task
factor of shape (..., T, r), per-member leading dims); the model options
that are not parameters, such as ``num_tasks``, ``derivatives``,
``shape_batch`` and ``adaptive_nugget``, go to the port's constructor under
the same names.  The same holds for ``StandardGP`` (whose options
``kernel_class`` and ``adaptive_nugget`` go to the constructor too).  A
whole model state (parameters, observations, sequence randomizations)
moves between the packages as an ``.npz`` file instead:
``utils/checkpoint.save_state`` / ``load_state``, which read and write the
JAX package's keys.
"""

import numpy as np
import torch


def load_jax_params(model, raw, trainable=None) -> None:
    """Set ``model``'s raw parameters from a ``{name: array}`` dict with the
    keys ``scale``, ``lengthscales``, ``noise``, ``factor_task_kernel`` and
    ``noise_task_kernel``, each of the shape the model already has, and,
    where ``trainable`` (``{name: bool}``) is given, which of them ``fit``
    trains."""
    missing = set(model.params) - set(raw)
    if missing:
        raise KeyError(f"raw parameters missing: {sorted(missing)}")
    new = {}
    for k, p in model.params.items():
        v = np.asarray(raw[k], dtype=np.float64)
        if v.shape != tuple(p.raw.shape):
            raise ValueError(f"{k}: shape {v.shape} != model's {tuple(p.raw.shape)}")
        new[k] = torch.tensor(v, dtype=model.dtype, device=model.device)
    model._set_raw(new)
    for k, flag in (trainable or {}).items():
        model.params[k] = model.params[k]._replace(trainable=bool(flag))
