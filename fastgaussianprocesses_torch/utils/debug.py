"""Dense-oracle self-verification (counterpart of
``fastgaussianprocesses_tpu/utils/debug.py``).

With ``FASTGPS_TORCH_DEBUG=1`` every fast solver a model builds is the
general solver, and it is checked against a brute-force dense Gram assembly:
a solve and the log-determinant must agree to tolerance.  The tests use the
same oracle directly.
"""

import numpy as np
import torch


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dense_gram(model, n=None):
    """The full multitask Gram matrix that the fast path solves, as a float64
    numpy array: diagonal blocks ``S_ll (K_ll + nu_l I)`` (the noise added
    before the task scaling, with ``adaptive_nugget`` scaled by the trace
    ratio to task 0), off-diagonal blocks ``S_l0l1 K_l0l1``.  For an
    unbatched task Gram only."""
    n = np.asarray(model.n if n is None else n, dtype=np.int64)
    S = _host(model.gram_matrix_tasks).astype(np.float64)
    if S.ndim != 2:
        raise ValueError("the dense oracle supports an unbatched task Gram only")
    noise = float(_host(model.noise).reshape(-1)[0])
    T = model.num_tasks
    kernels = {}
    for l0 in range(T):
        for l1 in range(T):
            xb0 = model.get_xb(l0, n=int(n[l0]))
            xb1 = model.get_xb(l1, n=int(n[l1]))
            kernels[(l0, l1)] = _host(model._kernel_explicit(
                xb0[:, None], xb1[None, :],
                model.derivatives[l0], model.derivatives[l1],
                model.derivatives_coeffs[l0], model.derivatives_coeffs[l1],
                model.scale, model.lengthscales)).astype(np.float64)
    if model.adaptive_nugget:
        tr00 = np.trace(kernels[(0, 0)])
        nus = [noise * abs(np.trace(kernels[(l, l)]) / tr00) for l in range(T)]
    else:
        nus = [noise] * T
    blocks = [[None] * T for _ in range(T)]
    for l0 in range(T):
        for l1 in range(T):
            kv = kernels[(l0, l1)].copy()
            if l0 == l1:
                kv += nus[l0] * np.eye(int(n[l0]))
            blocks[l0][l1] = S[l0, l1] * kv
    return np.block(blocks)


def check_fast_solver(model, solver, rtol=1e-4, atol=1e-6):
    """Raise ``AssertionError`` unless ``solver`` agrees with the dense
    oracle on one solve and on the log-determinant (skipped for a batched
    task Gram)."""
    if model.gram_matrix_tasks.ndim != 2:
        return
    K = dense_gram(model, solver.n)
    v = np.random.default_rng(0).normal(size=int(solver.n.sum()))
    got = _host(solver.gram_matrix_solve(torch.as_tensor(v, device=model.device)
                                         .to(model.dtype)))
    want = np.linalg.solve(K, v)
    if not np.allclose(got, want, rtol=rtol, atol=max(atol, rtol * np.abs(want).max())):
        raise AssertionError("FASTGPS_TORCH_DEBUG: fast solve disagrees with the dense oracle")
    _, logdet = np.linalg.slogdet(K)
    got_ld = float(_host(solver.factor.logdet).reshape(-1)[0])
    if not np.isclose(got_ld, logdet, rtol=1e-3):
        raise AssertionError(f"FASTGPS_TORCH_DEBUG: logdet {got_ld} vs dense {logdet}")
