"""Hyperparameter specification: shapes, transform pairs, trainability
(counterpart of ``fastgaussianprocesses_tpu/models/params.py``).

Each hyperparameter has a value shape whose leading dims must be a suffix of
``shape_batch``, a (to_raw, from_raw) transform pair (default log/exp for
positive parameters) and a trainable flag, the per-leaf mask of the Rprop
update (``fit/rprop``).
"""

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

LOG_EXP = (torch.log, torch.exp)
IDENTITY = (lambda x: x, lambda x: x)


class Param(NamedTuple):
    raw: torch.Tensor
    from_raw: Callable
    trainable: bool

    @property
    def value(self):
        return self.from_raw(self.raw)


def _check_batch_suffix(shape: Tuple[int, ...], shape_batch: Tuple[int, ...],
                        ndim_value: int, name: str):
    lead = shape[:len(shape) - ndim_value]
    if lead and tuple(lead) != tuple(shape_batch[len(shape_batch) - len(lead):]):
        raise ValueError(f"{name}: leading dims {lead} must be a suffix of "
                         f"shape_batch {shape_batch}")


def make_param(name: str, value, default_shape, tfs, trainable: bool, shape_batch,
               ndim_value: int, dtype, device, positive: bool = True,
               allow_nonneg: bool = False) -> Param:
    """Validate and build a parameter following the reference shape rules.
    The raw value is computed on the host in float64, then cast once."""
    if np.isscalar(value):
        shape = tuple(default_shape)
        np_value = np.full(shape, float(value), dtype=np.float64)
    else:
        np_value = np.asarray(value, dtype=np.float64)
        shape = np_value.shape
    _check_batch_suffix(shape, tuple(shape_batch), ndim_value, name)
    if positive:
        ok = (np_value >= 0).all() if allow_nonneg else (np_value > 0).all()
        if not ok:
            raise ValueError(f"{name} must be {'non-negative' if allow_nonneg else 'positive'}")
    to_raw, from_raw = tfs
    if not (callable(to_raw) and callable(from_raw)):
        raise TypeError(f"tfs_{name} must be a pair of callables")
    if to_raw is torch.log:
        raw_np = np.log(np_value)
    else:
        raw_np = np.asarray(to_raw(torch.as_tensor(np_value)))
    return Param(raw=torch.as_tensor(raw_np, dtype=dtype, device=device),
                 from_raw=from_raw, trainable=bool(trainable))
