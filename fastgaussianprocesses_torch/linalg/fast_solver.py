"""Frequency-domain solver types (counterpart of the start of
``fastgaussianprocesses_tpu/linalg/fast_solver.py``).

This slice serves single-task lattice models, whose solvers are diagonal in
frequency space; the multitask residue-block factorization comes with the
multitask slice.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class FastFactor(NamedTuple):
    """Factorized frequency-space Gram matrix.

    ``lam_eff``: (..., n) effective eigenvalues when T == 1, else None.
    ``inv``: (..., n_min, M, M) batched inverse when T > 1, else None.
    ``logdet``: (...,) real log-determinant of the full system.
    ``n_sorted``: static task sizes, descending.
    ``task_order`` / ``inv_task_order``: permutations between original and
    sorted task indexing.
    """

    lam_eff: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]
    logdet: torch.Tensor
    n_sorted: tuple
    task_order: tuple
    inv_task_order: tuple


def sort_tasks(n: Sequence[int]):
    """Descending-n task order and its inverse (stable)."""
    n = np.asarray(n, dtype=np.int64)
    task_order = tuple(int(i) for i in np.argsort(-n, kind="stable"))
    inv_task_order = tuple(int(i) for i in np.argsort(np.asarray(task_order), kind="stable"))
    return task_order, inv_task_order
