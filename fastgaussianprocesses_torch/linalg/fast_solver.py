"""Frequency-domain multitask solver for fast GPs (counterpart of
``fastgaussianprocesses_tpu/linalg/fast_solver.py``).

After the fast transform, the multitask Gram matrix is block-sparse in
frequency space: task l (sorted by descending n_l) contributes r_l = n_l /
n_min frequencies per residue class rho in [0, n_min), and frequencies only
couple within a residue class.  The whole (sum n_l)^2 system therefore
factorizes into n_min independent M x M systems, M = sum_l r_l, which are
assembled once as an (..., n_min, M, M) stack and inverted batched:

* M <= 3: closed cofactor forms, elementwise over the frequency batch;
* 3 < M <= 64: a recursive 2 x 2 block Schur ladder whose leaves are the
  closed forms, its products batched ``torch.matmul`` on the tiny blocks;
* M > 64: ``torch.linalg.inv`` / ``slogdet`` (complex blocks directly: the
  JAX package's real embedding exists only because the TPU lacks complex
  LU; the log|det| semantics are the same).

None of them is a Cholesky: derivative-informed blocks are indefinite over
part of hyperparameter space, and the fit visits such points.  A single
task (M == 1) is purely diagonal arithmetic on its eigenvalues.

For tasks l0 <= l1 (so n0 >= n1) the cross Gram is convolution by the first
column followed by inclusion of the size-n1 subgroup: in frequency space
``sqrt(n1) * ft(k1)[k]`` at (k, k mod n1).

Under a sequence mesh of D ranks (``group``), rank c holds frequencies
``[c n_l / D, (c + 1) n_l / D)`` of every task, which cut across the residue
classes.  The factorization and the solves therefore move each task's
vector into the residue layout first: rank c then holds residues
``[c m, (c + 1) m)``, m = n_min / D, with all r_l frequencies of each
(:func:`to_residues`, one ``all_to_all`` for all the vectors of a call), and
back after the solve (:func:`from_residues`, one more).  The blocks are
factorized where they land, and every sum over residues is an all-reduce,
so the log-determinant, traces and diagonals come out the same on every
rank.  This needs n_min % D == 0.
"""

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel import comm

# Coefficient of the dtype-relative eigenvalue floor EIG_FLOOR_C * eps * max|lam|
# that effective_lams adds (see there).
EIG_FLOOR_C = 8.0

# largest M the Schur ladder inverts; above it, LU
SCHUR_MAX_M = 64


class FastFactor(NamedTuple):
    """Factorized frequency-space Gram matrix.

    ``lam_eff``: (..., n) effective eigenvalues when T == 1, else None.
    ``inv``: (..., n_min, M, M) batched inverse when T > 1, else None.
    ``logdet``: (...,) real log-determinant of the full system.
    ``n_sorted``: static task sizes, descending.
    ``task_order`` / ``inv_task_order``: permutations between original and
    sorted task indexing.
    ``group``: the process group over whose ranks the frequency axis is
    split, or None.  With one task each rank holds its block of ``lam_eff``;
    with several, its residues' blocks of ``inv``, (..., n_min / D, M, M)
    (see the module docstring).
    """

    lam_eff: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]
    logdet: torch.Tensor
    n_sorted: tuple
    task_order: tuple
    inv_task_order: tuple
    group: object = None


def sort_tasks(n: Sequence[int]):
    """Descending-n task order and its inverse (stable)."""
    n = np.asarray(n, dtype=np.int64)
    task_order = tuple(int(i) for i in np.argsort(-n, kind="stable"))
    inv_task_order = tuple(int(i) for i in np.argsort(np.asarray(task_order), kind="stable"))
    return task_order, inv_task_order


def effective_lams(lam_pairs: dict, n_sorted, kmat_tasks, noise, task_order,
                   inv_task_order, adaptive_nugget: bool = False, group=None):
    """Noise, task-kernel scaling and the eigenvalue floor on the transformed
    first columns.

    Args:
        lam_pairs: ``{(l0, l1): ft(k1)}`` over sorted task positions
            l0 <= l1, each of length ``n_sorted[l0]`` (complex for the
            lattice, real for the digital net).
        kmat_tasks: (..., T, T) task Gram ``F F^T + diag(v)``; noise: (..., 1).
        adaptive_nugget: scale each task's noise by the trace ratio
            ``|tr K_ll / tr K_00|`` (task 0 in the original order).
        group: the process group whose ranks hold blocks of the frequency
            axis (one task only), or None; the traces and the floor's max
            are then taken over the whole axis.

    Returns:
        ``{(l0, l1): (..., n_sorted[l0])}`` with ``sqrt(n_sorted[l1]) * lam``,
        the noise added on diagonal pairs, times ``K_tasks[to0, to1]``, and
        on diagonal pairs the floor ``EIG_FLOOR_C * eps * max|.|``.

    The transform computes each eigenvalue with an absolute error of about
    eps * max|lam|, so eigenvalues below that level are rounding noise (maybe
    negative), and with a near-zero ``noise`` the solve would amplify them.
    The floor makes the solve well-posed in the working precision; it is
    invisible in float64.  It is differentiated on purpose: at near-zero
    noise the floored surface's smooth gradient comes from the floor term,
    and without it float32 samplers integrate rounding noise (the JAX
    package's finding, ``PERF_ANALYSIS.md`` section 4).
    """
    T = len(n_sorted)
    scaled = {}
    for (l0, l1), lam in lam_pairs.items():
        scaled[(l0, l1)] = _sqrt_n(int(n_sorted[l1]), lam.abs().dtype, lam.device) * lam
    if adaptive_nugget:
        root = inv_task_order[0]  # sorted position of original task 0
        tr00 = comm.all_sum(scaled[(root, root)].sum(-1), group)
        for l in range(T):
            trll = comm.all_sum(scaled[(l, l)].sum(-1), group)
            scaled[(l, l)] = scaled[(l, l)] + noise * (trll / tr00).abs()[..., None]
    else:
        for l in range(T):
            scaled[(l, l)] = scaled[(l, l)] + noise
    out = {}
    for (l0, l1), lam in scaled.items():
        out[(l0, l1)] = lam * kmat_tasks[..., task_order[l0], task_order[l1]][..., None]
    for l in range(T):
        lam_ll = out[(l, l)]
        eps = torch.finfo(lam_ll.abs().dtype).eps
        top = comm.all_amax(lam_ll.abs().amax(-1, keepdim=True), group)
        out[(l, l)] = lam_ll + EIG_FLOOR_C * eps * top
    return out


# the fit step reads the two constants below every step: each is built on the
# device once, as a host copy each time would synchronise the host with the card

@functools.lru_cache(maxsize=256)
def _sqrt_n(n: int, dtype, device):
    """``sqrt(n)`` as a 0-d tensor, computed in ``dtype`` on ``device``."""
    return torch.sqrt(torch.tensor(float(n), dtype=dtype, device=device))


@functools.lru_cache(maxsize=256)
def _residue_mask(r0: int, r1: int, dtype, device):
    """(r0, r1) mask of the frequencies ``(k, k mod n1)`` that couple in a
    task pair's residue block."""
    return torch.as_tensor((np.arange(r0)[:, None] % r1) == np.arange(r1)[None, :],
                           dtype=dtype, device=device)


def _pair_block(lr, r1: int):
    """(..., p, r0, r1) coupling block for one sorted task pair from its
    eigenvalues in the residue layout ``lr``, (..., r0, p): row j, residue i
    is frequency ``j n_min + i``."""
    r0 = lr.shape[-2]
    return lr.transpose(-1, -2)[..., :, None] * _residue_mask(r0, r1, lr.dtype, lr.device)


@functools.lru_cache(maxsize=64)
def _residue_plan(rs: tuple, m: int, D: int, c: int, device):
    """Rank c's index maps of :func:`to_residues` for vectors of r_v m entries
    each (``rs``).  In chunks of m entries, vector v is (r_v, D) chunks, row j,
    column d at global chunk ``g = j D + d``; rank c holds chunks
    ``[c r_v, (c + 1) r_v)`` and rank d wants column d.  Returns ``(send,
    in_splits, out_splits, recv, send_inv, recv_inv)``: ``send`` orders the
    rank's concatenated vectors by destination rank (then vector, then
    chunk), ``recv`` orders what arrives (by source rank, then vector, then
    chunk) into the rows of every vector, (sum r_v, m) flattened, and the
    last two are their inverse permutations."""
    send, in_splits = [], [0] * D
    for dst in range(D):
        off = 0
        for r in rs:
            for q in range(r):
                if (c * r + q) % D == dst:
                    send.append(off + q)
                    in_splits[dst] += m
            off += r
    arrived, out_splits = [], [0] * D
    for src in range(D):
        row = 0
        for r in rs:
            for j in range(r):
                if (j * D + c) // r == src:
                    arrived.append(row + j)
                    out_splits[src] += m
            row += r
    chunk = np.arange(m)
    send = (np.asarray(send)[:, None] * m + chunk).reshape(-1)
    recv = (np.argsort(arrived)[:, None] * m + chunk).reshape(-1)
    return (torch.as_tensor(send, device=device), tuple(in_splits), tuple(out_splits),
            torch.as_tensor(recv, device=device), torch.as_tensor(np.argsort(send), device=device),
            torch.as_tensor(np.argsort(recv), device=device))


def _cat_last(xs):
    batch = np.broadcast_shapes(*[tuple(x.shape[:-1]) for x in xs])
    return torch.cat([x.expand(batch + tuple(x.shape[-1:])) for x in xs], -1)


def to_residues(xs, rs, group):
    """Vectors ``xs`` (..., r_v m) of the frequency-block layout (each rank its
    block of every vector of r_v n_min entries) -> this rank's residues
    ``[c m, (c + 1) m)`` of each, as (..., r_v, m): one ``all_to_all``."""
    D, c = comm.size(group), comm.rank(group)
    m = xs[0].shape[-1] // rs[0]
    send, ins, outs, recv, _, _ = _residue_plan(tuple(rs), m, D, c, xs[0].device)
    got = comm.all_to_all(_cat_last(xs).index_select(-1, send), group, ins, outs)
    rows = got.index_select(-1, recv)
    rows = rows.reshape(rows.shape[:-1] + (sum(rs), m))
    return list(torch.split(rows, list(rs), -2))


def from_residues(ys, rs, group):
    """The inverse of :func:`to_residues`: (..., r_v, m) pieces -> the rank's
    blocks (..., r_v m), one ``all_to_all``."""
    D, c = comm.size(group), comm.rank(group)
    m = ys[0].shape[-1]
    _, ins, outs, _, send_inv, recv_inv = _residue_plan(tuple(rs), m, D, c, ys[0].device)
    rows = torch.cat(ys, -2)
    rows = rows.reshape(rows.shape[:-2] + (-1,))
    got = comm.all_to_all(rows.index_select(-1, recv_inv), group, outs, ins)
    blocks = got.index_select(-1, send_inv)
    return list(torch.split(blocks, [r * m for r in rs], -1))


def _on_first_rank(x, group):
    """``x`` of the rank that holds frequency (or residue) 0, on every rank:
    one all-reduce of the value zeroed elsewhere."""
    if group is None:
        return x
    return comm.all_sum(x if comm.rank(group) == 0 else torch.zeros_like(x), group)


def _inv_logdet_closed(theta, m: int):
    """Cofactor inverse and log|det| of batched m x m blocks, m <= 3,
    elementwise over the batch (complex blocks in complex arithmetic).  The
    caller's relative ridge bounds the conditioning, which makes the
    unpivoted closed form safe at these sizes."""
    if m == 1:
        det = theta[..., 0, 0]
        inv = (1.0 / det)[..., None, None]
    elif m == 2:
        a, b = theta[..., 0, 0], theta[..., 0, 1]
        c, d = theta[..., 1, 0], theta[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2) / det[..., None, None]
    else:
        a, b, c = theta[..., 0, 0], theta[..., 0, 1], theta[..., 0, 2]
        d, e, f = theta[..., 1, 0], theta[..., 1, 1], theta[..., 1, 2]
        g, h, i = theta[..., 2, 0], theta[..., 2, 1], theta[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        det = a * A + b * B + c * C
        adj = torch.stack([
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
        inv = adj / det[..., None, None]
    return inv, torch.log(det.abs())


def _inv_logdet_schur(theta, m: int):
    """Batched inverse and log|det| by recursive 2 x 2 block Schur
    complements, ``inv([[A, B], [C, D]])`` via ``S = D - C A^-1 B``, down to
    the m <= 3 closed forms.  ``log|det| = log|det A| + log|det S|``, valid
    for every invertible A, including the indefinite systems of
    derivative-informed kernels.  Each level loses about one digit against
    pivoted LU; the caller's relative ridge bounds the conditioning."""
    if m <= 3:
        return _inv_logdet_closed(theta, m)
    k = m // 2
    A, B = theta[..., :k, :k], theta[..., :k, k:]
    C, D = theta[..., k:, :k], theta[..., k:, k:]
    invA, logdetA = _inv_logdet_schur(A, k)
    CAi = torch.matmul(C, invA)
    invS, logdetS = _inv_logdet_schur(D - torch.matmul(CAi, B), m - k)
    TR = -torch.matmul(torch.matmul(invA, B), invS)
    TL = invA - torch.matmul(TR, CAi)
    BL = -torch.matmul(invS, CAi)
    return torch.cat([torch.cat([TL, TR], -1), torch.cat([BL, invS], -1)], -2), \
        logdetA + logdetS


def factorize(lams: dict, n_sorted, task_order, inv_task_order, group=None) -> FastFactor:
    """Factorize the frequency-space system: the batched inverse of its
    residue blocks and its log-determinant (for one task, the eigenvalues
    themselves and ``sum log|lam|``, summed over ``group``'s blocks)."""
    meta = dict(n_sorted=tuple(n_sorted), task_order=tuple(task_order),
                inv_task_order=tuple(inv_task_order))
    T = len(n_sorted)
    if T == 1:
        lam = lams[(0, 0)]
        return FastFactor(lam_eff=lam, inv=None, group=group,
                          logdet=comm.all_sum(torch.log(lam.abs()).sum(-1), group), **meta)
    n_min = int(n_sorted[-1])
    r = [int(nl) // n_min for nl in n_sorted]
    keys = [(l0, l1) for l0 in range(T) for l1 in range(l0, T)]
    if group is None:
        lrs = {k: lams[k].reshape(lams[k].shape[:-1] + (r[k[0]], n_min)) for k in keys}
    else:
        if n_min % comm.size(group):
            raise ValueError(f"the smallest task's n = {n_min} does not split over the "
                             f"{comm.size(group)} ranks of the sequence mesh")
        lrs = dict(zip(keys, to_residues([lams[k] for k in keys], [r[k[0]] for k in keys],
                                         group)))
    rows = []
    for l0 in range(T):
        cols = []
        for l1 in range(T):
            if l0 <= l1:
                cols.append(_pair_block(lrs[(l0, l1)], r[l1]))
            else:
                cols.append(_pair_block(lrs[(l1, l0)], r[l0]).transpose(-1, -2).conj())
        batch = np.broadcast_shapes(*[tuple(c.shape[:-2]) for c in cols])
        rows.append(torch.cat([c.expand(batch + tuple(c.shape[-2:])) for c in cols], -1))
    batch = np.broadcast_shapes(*[tuple(rw.shape[:-2]) for rw in rows])
    theta = torch.cat([rw.expand(batch + tuple(rw.shape[-2:])) for rw in rows], -2)
    m = theta.shape[-1]
    # relative ridge on the assembled blocks: derivative cross-blocks make
    # near-linearly-dependent rows, and with near-zero noise the working-
    # precision factorization loses accuracy; 8 eps max|diag| is rounding-level
    # regularization, mirroring the single-task eigenvalue floor
    dmag = torch.diagonal(theta, dim1=-2, dim2=-1).real.abs()
    ridge = 8.0 * torch.finfo(dmag.dtype).eps * dmag.amax(-1)
    theta = theta + ridge[..., None, None] * torch.eye(m, dtype=theta.dtype,
                                                       device=theta.device)
    if m <= SCHUR_MAX_M:
        inv, logdet = _inv_logdet_schur(theta, m)
    else:
        logdet = torch.linalg.slogdet(theta).logabsdet
        inv = torch.linalg.inv(theta)
    return FastFactor(lam_eff=None, inv=inv, logdet=comm.all_sum(logdet.sum(-1), group),
                      group=group, **meta)


def solve_tilde(factor: FastFactor, tildes, extra_ndim: int = 0):
    """Apply the inverse in tilde space: a list of tilde vectors, one per task
    in the original order, in and out.  ``extra_ndim`` dims between the
    factor's batch dims and the length axis (2 for (..., T, N, n) prediction
    blocks) broadcast the factor."""
    if factor.lam_eff is not None:
        lam = factor.lam_eff
        if extra_ndim:
            lam = lam.reshape(lam.shape[:-1] + (1,) * extra_ndim + lam.shape[-1:])
        return [tildes[0] / lam]
    n_min = int(factor.n_sorted[-1])
    r = [int(nl) // n_min for nl in factor.n_sorted]
    ys = [tildes[o] for o in factor.task_order]
    if factor.group is None:
        ys = [y.reshape(y.shape[:-1] + (rl, n_min)) for y, rl in zip(ys, r)]
    else:
        ys = to_residues(ys, r, factor.group)
    batch = np.broadcast_shapes(*[tuple(y.shape[:-2]) for y in ys])
    y = torch.cat([y.expand(batch + tuple(y.shape[-2:])) for y in ys], -2)  # (..., M, n_min)
    inv = factor.inv
    if extra_ndim:
        inv = inv.reshape(inv.shape[:-3] + (1,) * extra_ndim + inv.shape[-3:])
    m = inv.shape[-1]
    if m <= 8:
        # M^2 multiply-adds over (n_min,) vectors: a batched matmul over the
        # (n_min, M, M) blocks would broadcast the factor across every query
        # row first
        out = torch.stack([sum(inv[..., :, i, j] * y[..., j, :] for j in range(m))
                           for i in range(m)], -2)
    else:
        out = torch.einsum("...pij,...pj->...pi", inv, y.transpose(-1, -2)).transpose(-1, -2)
    pieces = list(torch.split(out, r, -2))
    if factor.group is None:
        outs = [p.reshape(p.shape[:-2] + (-1,)) for p in pieces]
    else:
        outs = from_residues(pieces, r, factor.group)
    return [outs[o] for o in factor.inv_task_order]


def trace_inverse(factor: FastFactor):
    """Real trace of the inverse Gram (the GCV denominator)."""
    if factor.lam_eff is not None:
        return comm.all_sum(torch.real(1.0 / factor.lam_eff).sum(-1), factor.group)
    return comm.all_sum(torch.diagonal(factor.inv, dim1=-2, dim2=-1).real.sum((-1, -2)),
                        factor.group)


def inv_diag_pointspace(factor: FastFactor, kind: str, point_class_fn):
    """Exact diagonal of ``K^-1`` in point space, one (..., n_l) tensor per
    task in the original order.

    Within sorted task l, frequencies couple across the r_l = n_l / n_min
    replicas of each residue, so the diagonal takes r_l distinct values,
    indexed by a point's class:

        diag_c = (1/n_l) sum_rho  v_c^H  B_rho  v_c,

    with B_rho the task's (r_l, r_l) inverse block at residue rho and the
    characters v_c[j] = exp(-2 pi i c j / r_l) (``kind="fourier"``) or
    (-1)^<c, j> (``"walsh"``).  ``point_class_fn(task, n_l, r_l)`` maps each
    of the task's points to its class in [0, r_l).  With one task every
    frequency is its own block and the diagonal is ``mean(Re(1/lam))``.
    Under a sequence mesh the sum over residues is an all-reduce, and each
    task's diagonal is the rank's block of its points.
    """
    if factor.lam_eff is not None:
        lam = factor.lam_eff
        if factor.group is None:
            val = torch.real(1.0 / lam).mean(-1)
        else:
            val = (comm.all_sum(torch.real(1.0 / lam).sum(-1), factor.group)
                   / float(factor.n_sorted[0]))
        return [val[..., None].expand(val.shape + (lam.shape[-1],))]
    n_sorted = factor.n_sorted
    n_min = int(n_sorted[-1])
    r = [int(nl) // n_min for nl in n_sorted]
    out_sorted, off = [], 0
    for l, rl in enumerate(r):
        block = factor.inv[..., off:off + rl, off:off + rl]  # (..., n_min, rl, rl)
        c = np.arange(rl)
        if kind == "fourier":
            v = np.exp(-2j * np.pi * np.outer(c, c) / rl)
        else:
            v = np.where(_popcount_and(c[:, None], c[None, :]) % 2 == 1, -1.0, 1.0)
        v = torch.as_tensor(v, device=block.device).to(block.dtype)
        vals = comm.all_sum(torch.einsum("cj,...pjk,ck->...c", v.conj(), block, v).real,
                            factor.group) / float(n_sorted[l])
        classes = np.asarray(point_class_fn(factor.task_order[l], int(n_sorted[l]), rl))
        if factor.group is not None:
            L = classes.shape[0] // comm.size(factor.group)
            classes = classes[comm.rank(factor.group) * L:(comm.rank(factor.group) + 1) * L]
        out_sorted.append(vals.index_select(-1, torch.as_tensor(classes, device=vals.device)))
        off += rl
    return [out_sorted[o] for o in factor.inv_task_order]


def _popcount_and(a, b):
    """Bit count of ``a & b`` for non-negative integer arrays."""
    x = (a & b).astype(np.uint64)
    count = np.zeros_like(x)
    while x.any():
        count += x & np.uint64(1)
        x >>= np.uint64(1)
    return count


def dc_block(factor: FastFactor):
    """(..., T, T) zero-frequency inverse entries in SORTED task order
    (posterior cubature); under a sequence mesh the first rank's, which holds
    frequency 0 (residue 0), on every rank."""
    if factor.lam_eff is not None:
        return _on_first_rank((1.0 / factor.lam_eff[..., 0])[..., None, None], factor.group)
    r = [int(nl) // int(factor.n_sorted[-1]) for nl in factor.n_sorted]
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(r)[:-1]]).astype(np.int64),
                              device=factor.inv.device)
    sub = factor.inv[..., 0, :, :]
    return _on_first_rank(sub.index_select(-2, offsets).index_select(-1, offsets), factor.group)
