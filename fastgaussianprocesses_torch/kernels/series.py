"""Series-form kernels: shift-invariant (lattice) and digitally-shift-invariant
(digital net) (counterpart of ``fastgaussianprocesses_tpu/kernels/series.py``).

Two pieces, as in the JAX package:

* ``si_parts_from_delta`` / ``dsi_parts_from_delta`` / ``kernel_parts`` --
  hyperparameter-independent per-dimension series terms, cached per point
  set;
* ``kernel_from_parts_t`` -- the cheap hyperparameter contraction
  ``scale * prod_j(ind_j + lengthscale_j * part_j)``.

``kernel_fused_scan`` evaluates cross-kernels at query scale without ever
materializing a ``(N, n, d)`` tensor.
"""

import numpy as np
import torch

from ..ops import si_cross
from ..ops.bernoulli import bernoulli_poly, si_coeff
from ..ops.walsh_closed import omega_walsh_closed, omega_walsh_closed_pair


def si_parts_from_delta(delta, alpha, beta, kappa):
    """Per-dimension SI series terms at lattice differences ``delta``.

    ``coeff_j * B_{2*alpha_j - beta_j - kappa_j}(delta_j)`` with
    ``coeff_j = (-1)^(alpha_j + kappa_j + 1) * (2 pi)^(2 alpha_j) /
    (2 alpha_j - beta_j - kappa_j)!``.

    Args:
        delta: (..., d) fractional differences in [0, 1).
        alpha, beta, kappa: int vectors of length d.

    Returns:
        (..., d) tensor of series terms.
    """
    alpha = np.asarray(alpha, dtype=np.int64)
    beta = np.asarray(beta, dtype=np.int64)
    kappa = np.asarray(kappa, dtype=np.int64)
    cols = []
    for j in range(delta.shape[-1]):
        a, b, k = int(alpha[j]), int(beta[j]), int(kappa[j])
        cols.append(si_coeff(a, b, k) * bernoulli_poly(2 * a - b - k, delta[..., j]))
    return torch.stack(cols, dim=-1)


def si_part_dim(delta_j, alpha_j: int, b: int, k: int):
    """One dimension's SI series term (scalar orders; see si_parts_from_delta).
    Returns a fresh buffer (callers may update it in place)."""
    return bernoulli_poly(2 * alpha_j - b - k, delta_j).mul_(si_coeff(alpha_j, b, k))


def lattice_ominus(x, z):
    """Group difference on the torus: ``(x - z) mod 1``."""
    return (x - z).remainder_(1.0)


def _dsi_order(alpha_j: int, bpk: int) -> int:
    order = alpha_j - bpk
    if not 1 <= order <= 4:
        raise ValueError(f"DSI order must be in [1, 4], got {order}")
    return order


def dsi_parts_from_delta(delta_b, t: int, alpha, beta, kappa, dtype=torch.float64):
    """Per-dimension DSI series terms at t-bit integer XOR differences.

    ``(-2)^(beta_j + kappa_j) * (ind_j + omega_{alpha_j - beta_j - kappa_j}(delta_j))``
    with ``ind_j = 1{beta_j + kappa_j > 0}``.

    Args:
        delta_b: (..., d) integer XOR differences.
        t: bit precision.
        alpha, beta, kappa: int vectors of length d.

    Returns:
        (..., d) tensor of series terms in ``dtype``.
    """
    alpha = np.asarray(alpha, dtype=np.int64)
    bpk = np.asarray(beta, dtype=np.int64) + np.asarray(kappa, dtype=np.int64)
    cols = [dsi_part_dim(delta_b[..., j], t, int(alpha[j]), int(bpk[j]), 0, dtype=dtype)
            for j in range(delta_b.shape[-1])]
    return torch.stack(cols, dim=-1)


def _dsi_term(om, bpk: int):
    """``(-2)^bpk * (1{bpk > 0} + omega)``, in place on the fresh ``om``."""
    return om.add_(1.0 if bpk > 0 else 0.0).mul_(float((-2.0) ** bpk))


def dsi_part_dim(delta_bj, t: int, alpha_j: int, b: int, k: int, dtype=torch.float64):
    """One dimension's DSI series term (scalar orders; see dsi_parts_from_delta).
    Returns a fresh buffer (callers may update it in place)."""
    om = omega_walsh_closed(delta_bj, t, _dsi_order(alpha_j, b + k), dtype=dtype)
    return _dsi_term(om, b + k)


def dsi_part_pair(xbj, zbj, t: int, alpha_j: int, b: int, k: int, dtype=torch.float64):
    """:func:`dsi_part_dim` at ``xbj XOR zbj`` for broadcastable sides, with the
    bit-spread features computed side-wise (``omega_walsh_closed_pair``)."""
    om = omega_walsh_closed_pair(xbj, zbj, t, _dsi_order(alpha_j, b + k), dtype=dtype)
    return _dsi_term(om, b + k)


def digital_ominus(xb, zb):
    """Group difference in base 2: bitwise XOR of t-bit integers."""
    return xb ^ zb


def kernel_parts(parts_fn, x_or_b, z_or_b, ominus, beta0, beta1):
    """Stack series terms over derivative multi-index pairs.

    Returns (..., p0, p1, d) where ``...`` are the broadcast spatial dims of
    ``ominus(x, z)``.
    """
    delta = ominus(x_or_b, z_or_b)
    rows = []
    for i0 in range(len(beta0)):
        cols = [parts_fn(delta, beta0[i0], beta1[i1]) for i1 in range(len(beta1))]
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)


def pair_consts(beta0, beta1, c0, c1, dtype, device):
    """The host constants of a task pair's contraction as tensors: the
    indicator ``beta0 + beta1 == 0`` (p0, p1, d) and the coefficients ``c0``
    (p0,) and ``c1`` (p1,).  A model builds them once
    (``AbstractFastGP._pair_consts``), as a host copy every fit step would
    synchronise the host with the card."""
    ind = (np.asarray(beta0)[:, None, :] + np.asarray(beta1)[None, :, :]) == 0
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in (ind, c0, c1))


def _factors(parts_t, lengthscales, ind):
    """The product's factors ``ind_j + ls_j * parts_t[..., j, :]``, one
    (*b, p0, p1, n) tensor at a time (one ``addcmul`` launch each)."""
    d = parts_t.shape[-2]
    aniso = lengthscales.shape[-1] == d
    for j in range(d):
        lsj = lengthscales[..., j if aniso else 0][..., None, None, None]    # (*b,1,1,1)
        yield torch.addcmul(ind[:, :, j, None], lsj, parts_t[..., j, :])


class _ProdTermsT(torch.autograd.Function):
    """``prod_j (ind_j + ls_j * parts_t[..., j, :])`` over the dimension axis,
    with the lengthscale cotangent written out (the JAX package's
    ``_prod_terms_t`` custom VJP): ``dL/dls_j = sum g * parts_j * prefix_j *
    suffix_j``, the products of the factors before and after j, so no
    division (a factor may be zero).  The forward keeps its running
    products, the prefixes; the backward walks j down with the running
    suffix times the cotangent, two passes over n and one dot product a
    dimension.  The parts are data and get no gradient."""

    @staticmethod
    def forward(ctx, parts_t, lengthscales, ind):
        prefixes, terms = [], None
        for f in _factors(parts_t, lengthscales, ind):
            if terms is None:
                terms = f
            elif ctx.needs_input_grad[1]:
                prefixes.append(terms)
                terms = terms * f
            else:
                terms.mul_(f)
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(parts_t, lengthscales, ind, *prefixes)
        return terms

    @staticmethod
    def backward(ctx, g):
        parts_t, ls, ind, *prefixes = ctx.saved_tensors
        d = parts_t.shape[-2]
        fs = list(_factors(parts_t, ls, ind))
        run = g                                      # g * suffix_j
        cols = [None] * d
        for j in range(d - 1, -1, -1):
            t = run if j == 0 else run * prefixes[j - 1]
            cols[j] = torch.einsum("...pqn,pqn->...", t, parts_t[..., j, :])
            if j:
                run = run * fs[j]
        dls = torch.stack(cols, -1)
        if ls.shape[-1] != d:
            dls = dls.sum(-1, keepdim=True)
        return None, dls.sum_to_size(ls.shape), None


def _prod_terms_t(parts_t, lengthscales, ind):
    return _ProdTermsT.apply(parts_t, lengthscales, ind)


def kernel_from_parts_t(parts_t, beta0, beta1, c0, c1, scale, lengthscales):
    """Hyperparameter contraction of first-column parts in the ``(p0, p1, d, n)``
    layout (point axis last), differentiable in ``scale`` and
    ``lengthscales`` (:class:`_ProdTermsT` writes the lengthscale cotangent
    out, as the JAX package's ``_prod_terms_t`` does).

    Args:
        parts_t: (p0, p1, d, n).
        scale: (*batch, 1); lengthscales: (*batch, d) or (*batch, 1).

    Returns:
        (*batch_broadcast, n) kernel first-column values.
    """
    consts = pair_consts(beta0, beta1, c0, c1, parts_t.dtype, parts_t.device)
    return kernel_from_consts_t(parts_t, consts, scale, lengthscales)


def kernel_from_consts_t(parts_t, consts, scale, lengthscales):
    """:func:`kernel_from_parts_t` with the pair's :func:`pair_consts`
    already on the device."""
    ind, c0, c1 = consts
    # the product over d written out: no (*b, p0, p1, d, n) temporary, and no
    # torch.prod reduction kernel (its first use on the card costs seconds of
    # module loading)
    terms = _prod_terms_t(parts_t, lengthscales, ind)                  # (*b,p0,p1,n)
    out = torch.sum(torch.sum(terms * c1[:, None], dim=-2) * c0[:, None], dim=-2)
    return scale * out


def kernel_fused_scan(part_dim_fn, x_or_b, z_or_b, ominus, beta0, beta1, c0, c1,
                      scale, lengthscales, alpha, part_dim_pair_fn=None, bernoulli=False,
                      factor=None):
    """Kernel values without the ``(..., d)`` parts tensor: a loop over
    dimension groups accumulating the product in one running buffer.

    At query scale (chunk of ~59 rows against n = 2^20 points, d = 8) one
    ``(chunk, n, d)`` tensor would be 2 GB; this loop keeps the live set to a
    few ``(chunk, n)`` buffers (the running product, the current delta, the
    current term) whatever ``d`` is.  Dimensions are grouped by their series
    signature ``(alpha_j, beta0_j, beta1_j)`` and multiplied group by group
    in the JAX package's order (its ``lax.scan`` per group), so float64
    results agree to roundoff.

    ``part_dim_fn(delta_j, j, b, k)`` may depend on ``j`` only through
    ``alpha[j]``.  ``part_dim_pair_fn(xj, zj, j, b, k)``, where given, takes
    its place and is evaluated on the broadcastable sides instead of the
    delta, so that a model can compute per-side features once (the digital
    net's XOR-commuting bit spreads).  Both return a fresh buffer.

    ``bernoulli=True`` says that ``part_dim_fn`` is :func:`si_part_dim` and
    ``ominus`` :func:`lattice_ominus` (the lattice's series).  On CUDA
    tensors, in the outer layout ``x (N, 1, d)`` against ``z (1, M, d)`` or
    the paired one ``x (N, d)`` against ``z (N, d)``, the whole product and
    sum then run in kernel K5 (``ops/si_cross``), which stores the result
    once.  CPU tensors keep the loop, and so do two kinds of CUDA call:
    other layouts (the public ``kernel()`` of points that broadcast
    otherwise, such as (N, d) against (M, d) with N != M) and calls that
    need a gradient (a posterior or ``kernel()`` differentiated in its
    points or hyperparameters), since K5 has no backward.  The serving
    paths (``post_mean``, ``post_var``, ``post_mean_var``, ``post_cov``)
    take K5 for every query chunk.  ``factor`` (a task factor, broadcastable against the result) multiplies
    the result: K5 folds it into its scalar, the loop multiplies afterwards.
    """
    if bernoulli and x_or_b.is_cuda and _k5_layout(x_or_b, z_or_b) and not (
            torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in
                                            (x_or_b, z_or_b, scale, lengthscales, factor))):
        return _k5(x_or_b, z_or_b, beta0, beta1, c0, c1, scale, lengthscales, alpha, factor)
    d = x_or_b.shape[-1]
    alpha = np.broadcast_to(np.asarray(alpha, dtype=np.int64), (d,))
    dtype = scale.dtype
    ls = lengthscales + torch.zeros((d,), dtype=dtype, device=scale.device)  # (*batch, d)
    batch = tuple(ls.shape[:-1])
    # numpy, not torch.broadcast_shapes: the torch one imports sympy on first
    # use, seconds of a process's first query
    sp = tuple(np.broadcast_shapes(tuple(x_or_b.shape[:-1]), tuple(z_or_b.shape[:-1])))
    sp_ndim = len(sp)
    total = None
    for i0 in range(len(beta0)):
        for i1 in range(len(beta1)):
            groups = {}
            for j in range(d):
                key = (int(alpha[j]), int(beta0[i0, j]), int(beta1[i1, j]))
                groups.setdefault(key, []).append(j)
            prod = torch.ones(batch + sp, dtype=dtype, device=scale.device)
            for (_, b, k), idx in groups.items():
                ind = 1.0 if (b + k) == 0 else 0.0
                for j in idx:
                    if part_dim_pair_fn is not None:
                        part = part_dim_pair_fn(x_or_b[..., j], z_or_b[..., j], idx[0], b, k)
                    else:
                        delta = ominus(x_or_b[..., j], z_or_b[..., j])
                        part = part_dim_fn(delta, idx[0], b, k)
                        del delta
                    lsj = ls[..., j].reshape(batch + (1,) * sp_ndim)
                    term = part.mul_(lsj) if not batch else part * lsj
                    prod.mul_(term.add_(ind))
                    del part, term
            w = float(c0[i0] * c1[i1])
            contrib = prod if w == 1.0 else w * prod
            total = contrib if total is None else total + contrib
    scale_r = scale[..., 0].reshape(tuple(scale.shape[:-1]) + (1,) * sp_ndim)
    return times_factor(scale_r * total, factor)


def times_factor(kv, factor):
    """Kernel values ``kv`` times a task ``factor`` (None: unchanged), in
    place where the product keeps ``kv``'s shape (a query chunk's values
    are one large buffer)."""
    if factor is None:
        return kv
    return kv.mul_(factor) if factor.dim() <= 2 and kv.dim() >= 2 else kv * factor


def _k5_layout(x, z) -> bool:
    """Whether ``x`` against ``z`` is the outer layout (N, 1, d) against
    (1, M, d) or the paired one (N, d) against (N, d), which K5 takes."""
    if x.dim() == 3 and z.dim() == 3:
        return x.shape[1] == 1 and z.shape[0] == 1 and x.shape[2] == z.shape[2]
    return x.dim() == 2 and tuple(x.shape) == tuple(z.shape)


def _k5(x, z, beta0, beta1, c0, c1, scale, lengthscales, alpha, factor):
    """:func:`kernel_fused_scan`'s result through K5: the batch dimensions of
    the scale, the lengthscales and the factor broadcast and flattened into
    the kernel's rows (views where nothing broadcasts: no device work before
    the launch)."""
    d = x.shape[-1]
    paired = x.dim() == 2
    ls = lengthscales.to(scale.dtype)
    if ls.shape[-1] != d:
        ls = ls.expand(tuple(ls.shape[:-1]) + (d,))
    sc = scale[..., 0]
    # the factor without its trailing singleton dimensions (those of the result's points)
    f = None if factor is None else factor.reshape(tuple(factor.shape[:factor.dim() + 1 - x.dim()]))
    batch = tuple(np.broadcast_shapes(tuple(sc.shape), tuple(ls.shape[:-1]),
                                      () if f is None else tuple(f.shape)))

    def flat(t, tail=()):
        return t.expand(batch + tail).reshape((-1,) + tail).contiguous()

    out = si_cross.si_cross((x if paired else x[:, 0]).contiguous(),
                            (z if paired else z[0]).contiguous(), alpha, beta0, beta1, c0, c1,
                            flat(sc), flat(ls, (d,)), None if f is None else flat(f), paired=paired)
    return out.reshape(batch + tuple(out.shape[1:]))
