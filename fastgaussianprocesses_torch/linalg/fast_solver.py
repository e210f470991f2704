"""Frequency-domain solver for fast GPs, single-task half (counterpart of
``fastgaussianprocesses_tpu/linalg/fast_solver.py``).

After the fast transform a single-task Gram matrix is diagonal in frequency
space, so factorizing it is elementwise arithmetic on its eigenvalues.  The
multitask residue-block factorization comes with the multitask slice;
``effective_lams`` and ``factorize`` raise ``NotImplementedError`` for more
than one task.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

# Coefficient of the dtype-relative eigenvalue floor EIG_FLOOR_C * eps * max|lam|
# that effective_lams adds (see there).
EIG_FLOOR_C = 8.0


def require_single_task(num_tasks: int) -> None:
    if num_tasks != 1:
        raise NotImplementedError(
            "this model needs the general multitask fast solver, which the port gains "
            "with its multitask slice (ROADMAP queue 1 item 5)")


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


def effective_lams(lam_pairs: dict, n_sorted, kmat_tasks, noise):
    """Noise, task-kernel scaling and the eigenvalue floor on the transformed
    first column of one task: ``(sqrt(n) lam + noise) * K_tasks[0, 0]`` plus
    ``EIG_FLOOR_C * eps * max|.|``.

    The transform computes each eigenvalue with an absolute error of about
    eps * max|lam|, so eigenvalues below that level are rounding noise (maybe
    negative), and with a near-zero ``noise`` the solve would amplify them.
    The floor makes the solve well-posed in the working precision; it is
    invisible in float64.  (With one task the JAX package's adaptive-nugget
    trace ratio is 1, so it has no counterpart here.)

    Args:
        lam_pairs: ``{(0, 0): ft(k1)}``, real (digital net) or complex.
        n_sorted: ``(n,)``.
        kmat_tasks: (..., 1, 1) task Gram; noise: (..., 1).

    Returns:
        ``{(0, 0): (..., n)}`` effective eigenvalues.
    """
    require_single_task(len(n_sorted))
    lam = lam_pairs[(0, 0)]
    rdt = lam.abs().dtype
    lam = torch.sqrt(torch.tensor(float(n_sorted[0]), dtype=rdt, device=lam.device)) * lam
    lam = (lam + noise) * kmat_tasks[..., 0, 0][..., None]
    floor = EIG_FLOOR_C * torch.finfo(rdt).eps * lam.abs().amax(-1, keepdim=True)
    return {(0, 0): lam + floor}


def factorize(lams: dict, n_sorted, task_order, inv_task_order) -> FastFactor:
    """Factorize the frequency-space system: for one task the eigenvalues
    themselves and the log-determinant ``sum log|lam|``."""
    require_single_task(len(n_sorted))
    lam = lams[(0, 0)]
    return FastFactor(lam_eff=lam, inv=None, logdet=torch.log(lam.abs()).sum(-1),
                      n_sorted=tuple(n_sorted), task_order=tuple(task_order),
                      inv_task_order=tuple(inv_task_order))


def solve_tilde(factor: FastFactor, tildes, extra_ndim: int = 0):
    """Apply the inverse in tilde space (a list with one tilde vector in and
    out).  ``extra_ndim`` dims between the factor's batch dims and the length
    axis (2 for (..., T, N, n) prediction blocks) broadcast the factor."""
    lam = factor.lam_eff
    if extra_ndim:
        lam = lam.reshape(lam.shape[:-1] + (1,) * extra_ndim + lam.shape[-1:])
    return [tildes[0] / lam]


def dc_block(factor: FastFactor):
    """(..., 1, 1) zero-frequency inverse entry (posterior cubature)."""
    return (1.0 / factor.lam_eff[..., 0])[..., None, None]


def trace_inverse(factor: FastFactor):
    """Real trace of the inverse Gram (the GCV denominator)."""
    require_single_task(len(factor.n_sorted))
    return torch.real(1.0 / factor.lam_eff).sum(-1)


def inv_diag_pointspace(factor: FastFactor, kind: str, point_class_fn):
    """Exact diagonal of ``K^-1`` in point space, one (..., n_l) tensor per
    task in the original order.  With one task every frequency is its own
    block, so the diagonal is constant, ``mean(Re(1/lam))``; ``kind``
    (``"fourier"`` or ``"walsh"``) and ``point_class_fn`` (each point's
    class among the coupled frequencies) serve the multitask residue blocks,
    which come with the multitask slice."""
    require_single_task(len(factor.n_sorted))
    lam = factor.lam_eff
    val = torch.real(1.0 / lam).mean(-1)
    return [val[..., None].expand(val.shape + (lam.shape[-1],))]
