"""Fast GP engine shared by the lattice (FFT) and digital-net (FWHT) models
(counterpart of ``fastgaussianprocesses_tpu/models/fast.py``).

Everything on the training side runs in frequency ("tilde") space in
O(n log n): eigenvalues are transforms of first Gram columns, the MLL, GCV
and CV losses are sums over them, and posterior cubature reads the
zero-frequency block.  Three solvers, each differentiable in the raw
hyperparameters (``fit``):

* ``_PermSpectrumSolver`` -- single-task lattice, full spectrum in the
  permuted bin order of ``ops/perm_fft`` (kernels K1-K3), chosen on the CUDA
  card in float32 for n = 2^14..2^22;
* ``_HalfSpectrumSolver`` -- single-task lattice, the Hermitian half
  spectrum over ``torch.fft``, for float64 and small n;
* ``_FastSolver`` -- the general multitask solver over the model's ``_ft`` /
  ``_ift`` (the digital net's FWHT, kernel K4 on the card; the lattice's
  full-spectrum FFT over ``torch.fft``) and the residue-block factorization
  of ``linalg/fast_solver``.

With ``FASTGPS_TORCH_DEBUG=1`` the general solver serves every model and each
new solver is checked against the dense oracle (``utils/debug``).
"""

import os

import numpy as np
import torch

from ..config import debug_checks_enabled
from ..kernels import series
from ..linalg import fast_solver as fs
from ..ops import perm_fft
from ..ops import transforms as tr
from ..ops.bitops import log2_int
from ..parallel import comm
from .abstract import AbstractGP, _as_task_array, _cat


def _sorted_pairs(task_order, n):
    """``(l0, l1, a, b, length)`` for every sorted task pair l0 <= l1: the
    original tasks ``a <= b`` whose first-column parts it reads, and its
    length ``n[task_order[l0]]``, in the order of ``_fit_data``'s parts."""
    T = len(task_order)
    out = []
    for l0 in range(T):
        for l1 in range(l0, T):
            to0, to1 = task_order[l0], task_order[l1]
            out.append((l0, l1, min(to0, to1), max(to0, to1), int(n[to0])))
    return out


def _eigenvalues(model, raw, n, task_order, inv_task_order, data, ft):
    """``fs.effective_lams`` of every sorted task pair's first column
    transformed by ``ft`` (one transform a pair, conjugated where the pair's
    original order is reversed), recomputed from the series parts for every
    solver handle, as in the JAX package: from the fit's ``data`` where
    given, else from the model's cache.  Returns the eigenvalues, the task
    Gram and the scale."""
    params = model._transformed(raw)
    kmat_tasks = model._task_gram(raw)
    lam_pairs = {}
    for i, (l0, l1, a, b, nlen) in enumerate(_sorted_pairs(task_order, n)):
        k1p = data[0][i] if data is not None else model._get_k1parts_lam(a, b, nlen)
        lam = ft(series.kernel_from_consts_t(k1p, model._pair_consts(a, b, k1p.dtype),
                                             params["scale"], params["lengthscales"]))
        lam_pairs[(l0, l1)] = lam.conj() if task_order[l0] > task_order[l1] else lam
    n_sorted = tuple(int(n[o]) for o in task_order)
    lams = fs.effective_lams(lam_pairs, n_sorted, kmat_tasks, params["noise"], task_order,
                             inv_task_order, model.adaptive_nugget, group=model._seq_group)
    return lams, kmat_tasks, params["scale"]


class _FastSolver:
    """Frequency-space solver handle for one (params, n-vector) instance over
    the model's ``_ft`` / ``_ift`` hooks, any number of tasks.

    ``data``: the fit's ``(k1parts, ytildes)`` (``AbstractFastGP._fit_data``).

    Under a sequence mesh (``use_sequence_sharding``) every tensor along the
    frequency axis is this rank's block, and each sum over that axis is a
    differentiable all-reduce over the mesh axis's group, so that every rank
    holds the same loss.  The point-space vectors it takes and returns
    (query rows, coefficients) are then the rank's block of each task's
    points (``model._cols``), and its quadratic forms are all-reduced.
    """

    def __init__(self, model, raw, n, data=None):
        self.model = model
        self.n = np.asarray(n, dtype=np.int64)
        if not (self.n > 0).all():
            raise ValueError("all tasks need data (or a future n) for fast solves")
        self.task_order, self.inv_task_order = fs.sort_tasks(self.n)
        self.n_sorted = tuple(int(self.n[o]) for o in self.task_order)
        self._data = data
        self.group = model._seq_group
        self._cols = model._cols(self.n)
        lams, self.kmat_tasks, self.scale = _eigenvalues(
            model, raw, self.n, self.task_order, self.inv_task_order, data, model._ft_lam)
        self.factor = fs.factorize(lams, self.n_sorted, self.task_order, self.inv_task_order,
                                   group=self.group)

    def _split(self, ycat):
        offs = np.concatenate([[0], np.cumsum(self._cols)])
        return [ycat[..., offs[l]:offs[l + 1]] for l in range(len(self.n))]

    # ``pre_permuted``: the rows are in the model's query column order, so the
    # model's ``_ft_q`` / ``_ift_q`` may skip a gather (the output stays in
    # that order)
    def gram_matrix_solve(self, ycat, extra_ndim=0, pre_permuted=False):
        """Real-space solve ``K^-1 y`` along the last axis."""
        yst = [self.model._ft_q(y, pre_permuted) for y in self._split(ycat)]
        zst = fs.solve_tilde(self.factor, yst, extra_ndim=extra_ndim)
        return _cat([torch.real(self.model._ift_q(z, pre_permuted)) for z in zst], -1)

    def gram_quad_diag(self, ycat, extra_ndim=0, pre_permuted=False):
        """Diagonal of ``Y K^-1 Y^T`` for stacked rows ``ycat``, in tilde space:
        the transforms are unitary, so ``y^T K^-1 y = sum_l <y~_l, z~_l>``
        (Parseval)."""
        yst = [self.model._ft_q(y, pre_permuted) for y in self._split(ycat)]
        zst = fs.solve_tilde(self.factor, yst, extra_ndim=extra_ndim)
        return comm.all_sum(sum(torch.real(a.conj() * b).sum(-1) for a, b in zip(yst, zst)),
                            self.group)

    def _ytildes(self):
        if self._data is not None:
            return list(self._data[1])
        return [self.model._get_ytilde(l, int(self.n[l])) for l in range(self.model.num_tasks)]

    def norm_logdet_terms(self):
        """The MLL's quadratic and log-determinant terms, (..., 1) each."""
        yts = self._ytildes()
        yt, zt = _cat(yts, -1), _cat(fs.solve_tilde(self.factor, yts), -1)
        norm = comm.all_sum(torch.real(yt.conj() * zt).sum(-1, keepdim=True), self.group)
        return norm, self.factor.logdet[..., None]

    def gcv_terms(self):
        """Generalized cross-validation numerator and denominator."""
        zt = _cat(fs.solve_tilde(self.factor, self._ytildes()), -1)
        numer = comm.all_sum(torch.real(zt.conj() * zt).sum(-1, keepdim=True), self.group)
        denom = ((fs.trace_inverse(self.factor) / float(self.n.sum())) ** 2)[..., None]
        return numer, denom

    def coeffs(self):
        """``K^-1 y`` in point space (the rank's blocks under a mesh)."""
        zts = fs.solve_tilde(self.factor, self._ytildes())
        return _cat([torch.real(self.model._ift(z)) for z in zts], -1)

    def inv_diag(self):
        """Exact diagonal of ``K^-1`` in point space (concatenated over tasks)."""
        cols = fs.inv_diag_pointspace(self.factor, self.model._char_kind,
                                      self.model._point_class)
        batch = np.broadcast_shapes(*[tuple(c.shape[:-1]) for c in cols])
        return _cat([c.expand(batch + tuple(c.shape[-1:])) for c in cols], -1)

    def dc_block(self):
        return fs.dc_block(self.factor)


class _HalfSpectrumSolver:
    r"""Single-task Fourier solver on the rfft half spectrum.

    The first Gram column and the observations are real, so the full
    spectrum is Hermitian; every reduction is a weighted half-spectrum sum
    (weight 2 except bins 0 and n/2) and every transform an rfft/irfft.
    """

    def __init__(self, model, raw, n, data=None):
        self.model = model
        self.n = np.asarray(n, dtype=np.int64)
        self.task_order, self.inv_task_order = (0,), (0,)
        self.n_sorted = (int(self.n[0]),)
        self._data = data
        lams, self.kmat_tasks, self.scale = _eigenvalues(
            model, raw, self.n, self.task_order, self.inv_task_order, data, model._ft_lam_half)
        self.lam = lams[(0, 0)]
        self.logdet = self._wsum(torch.log(self.lam.abs()))
        self.factor = fs.FastFactor(
            lam_eff=None, inv=None, logdet=self.logdet, n_sorted=self.n_sorted,
            task_order=self.task_order, inv_task_order=self.inv_task_order)

    @staticmethod
    def _wsum(x):
        """Full-spectrum sum from half-spectrum values (Hermitian pairing)."""
        return 2.0 * x.sum(-1) - x[..., 0] - x[..., -1]

    def _lam_b(self, extra_ndim):
        lam = self.lam
        if extra_ndim:
            lam = lam.reshape(lam.shape[:-1] + (1,) * extra_ndim + lam.shape[-1:])
        return lam

    def _ytilde_half(self):
        if self._data is not None:
            return self._data[1][0]
        return self.model._get_ytilde_half(0, int(self.n[0]))

    def norm_logdet_terms(self):
        yt = self._ytilde_half()
        norm = self._wsum(torch.real(torch.conj(yt) * (yt / self.lam)))[..., None]
        return norm, self.logdet[..., None]

    def gcv_terms(self):
        zt = self._ytilde_half() / self.lam
        numer = self._wsum(torch.real(torch.conj(zt) * zt))[..., None]
        tr_inv = self._wsum(torch.real(1.0 / self.lam))
        return numer, ((tr_inv / float(self.n.sum())) ** 2)[..., None]

    def coeffs(self):
        return self.model._ift_half(self._ytilde_half() / self.lam, int(self.n[0]))

    def gram_matrix_solve(self, ycat, extra_ndim=0, pre_permuted=False):
        yst = self.model._ft_half_q(ycat, pre_permuted)
        return self.model._ift_half_q(yst / self._lam_b(extra_ndim), int(self.n[0]),
                                      pre_permuted)

    def gram_quad_diag(self, ycat, extra_ndim=0, pre_permuted=False):
        yst = self.model._ft_half_q(ycat, pre_permuted)
        zt = yst / self._lam_b(extra_ndim)
        return self._wsum(torch.real(torch.conj(yst) * zt))

    def inv_diag(self):
        n0 = int(self.n[0])
        val = self._wsum(torch.real(1.0 / self.lam)) / float(n0)
        return val[..., None].expand(val.shape + (n0,))

    def dc_block(self):
        return (1.0 / self.lam[..., 0])[..., None, None]


class _PermSpectrumSolver:
    r"""Single-task Fourier solver on the FULL spectrum in the permuted bin
    order of ``ops/perm_fft``.

    The permuted layout relabels frequency bins: every reduction is a plain
    sum over all n bins, the DC bin stays at index 0 (cubature), and the
    forward/inverse transforms are layout-consistent by construction.  Bin
    for bin the eigenvalues match the JAX package's ``_PermSpectrumSolver``.
    """

    def __init__(self, model, raw, n, data=None):
        self.model = model
        self.n = np.asarray(n, dtype=np.int64)
        self.task_order, self.inv_task_order = (0,), (0,)
        self.n_sorted = (int(self.n[0]),)
        self._data = data
        lams, self.kmat_tasks, self.scale = _eigenvalues(
            model, raw, self.n, self.task_order, self.inv_task_order, data, model._ft_lam_perm)
        self.lam = lams[(0, 0)]
        self.logdet = torch.log(self.lam.abs()).sum(-1)
        self.factor = fs.FastFactor(
            lam_eff=None, inv=None, logdet=self.logdet, n_sorted=self.n_sorted,
            task_order=self.task_order, inv_task_order=self.inv_task_order)

    def _lam_b(self, extra_ndim):
        lam = self.lam
        if extra_ndim:
            lam = lam.reshape(lam.shape[:-1] + (1,) * extra_ndim + lam.shape[-1:])
        return lam

    def _ytilde(self):
        if self._data is not None:
            return self._data[1][0]
        return self.model._get_ytilde_perm(0, int(self.n[0]))

    def norm_logdet_terms(self):
        yt = self._ytilde()
        norm = torch.real(torch.conj(yt) * (yt / self.lam)).sum(-1)[..., None]
        return norm, self.logdet[..., None]

    def gcv_terms(self):
        zt = self._ytilde() / self.lam
        numer = torch.real(torch.conj(zt) * zt).sum(-1)[..., None]
        tr_inv = torch.real(1.0 / self.lam).sum(-1)
        return numer, ((tr_inv / float(self.n.sum())) ** 2)[..., None]

    def coeffs(self):
        return self.model._ift_perm_coeffs(self._ytilde() / self.lam, int(self.n[0]))

    def gram_matrix_solve(self, ycat, extra_ndim=0, pre_permuted=False):
        yst = self.model._ft_perm_q(ycat, pre_permuted)
        return self.model._ift_perm_q(yst / self._lam_b(extra_ndim), int(self.n[0]),
                                      pre_permuted)

    def inv_diag(self):
        n0 = int(self.n[0])
        val = torch.real(1.0 / self.lam).sum(-1) / float(n0)
        return val[..., None].expand(val.shape + (n0,))

    def gram_quad_diag(self, ycat, extra_ndim=0, pre_permuted=False):
        if pre_permuted:
            # fused kernel K3: sum_b Re(1/lam_b) |ft(row)_b|^2 per row, the
            # spectrum never written to device memory -- the posterior-variance
            # hot path; a fleet (batched lam) runs it once per member, each
            # with its own weights
            n0 = int(self.n[0])
            w = torch.real(1.0 / self.lam)
            if w.ndim == 1:
                return perm_fft.pfft_quad(ycat, w, n0)
            nb = ycat.ndim - 1 - extra_ndim
            batch = np.broadcast_shapes(tuple(ycat.shape[:nb]), tuple(w.shape[:-1]))
            rows = tuple(ycat.shape[nb:-1])
            yb = ycat.expand(batch + rows + (n0,)).reshape((-1,) + rows + (n0,))
            wb = w.expand(batch + (n0,)).reshape(-1, n0)
            return torch.stack([perm_fft.pfft_quad(yb[i], wb[i], n0)
                                for i in range(wb.shape[0])]).reshape(batch + rows)
        yst = self.model._ft_perm_q(ycat, pre_permuted)
        zt = yst / self._lam_b(extra_ndim)
        return torch.real(torch.conj(yst) * zt).sum(-1)

    def dc_block(self):
        return (1.0 / self.lam[..., 0])[..., None, None]


def make_solver(model, raw, n, data=None):
    """Solver factory: permuted-spectrum kernels, then half spectrum, then the
    general solver.  ``data``: the fit's ``(k1parts, ytildes)``."""
    if model._use_perm_spectrum(n):
        return _PermSpectrumSolver(model, raw, n, data=data)
    if model._use_half_spectrum(n):
        return _HalfSpectrumSolver(model, raw, n, data=data)
    return _FastSolver(model, raw, n, data=data)


class AbstractFastGP(AbstractGP):
    """Shared machinery for fast (transform-diagonalized) GPs."""

    def __init__(self, alpha, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if np.isscalar(alpha):
            alpha = int(alpha) * np.ones(self.d, dtype=np.int64)
        self.alpha = np.asarray(alpha, dtype=np.int64)
        if self.alpha.shape != (self.d,):
            raise ValueError(f"alpha needs {self.d} entries")
        self._k1parts_cache = {}         # (l0, l1) -> (n, p0, p1, d) device tensor
        self._k1parts_lam_cache = {}     # (l0, l1, n) -> (p0, p1, d, n) solver layout
        self._solver_cache = {}          # (version, n-tuple) -> solver
        self._pair_consts_cache = {}     # (a, b, dtype) -> series.pair_consts
        self._ytilde_cache = {}          # (task, n) -> _ft ytilde (general solver)
        self._ytilde_half_cache = {}     # (task, n) -> rfft ytilde
        self._ytilde_perm_cache = {}     # (task, n) -> perm-spectrum ytilde

    # -- sequence parallelism (the transform axis n over a mesh axis) -----
    def use_sequence_sharding(self, mesh, axis: str = "seq"):
        """Split the transform axis n over the mesh axis ``axis`` for every
        solve: the fit, serving and the hyperposterior (``mesh=None`` turns
        it off).  Every rank of the mesh must add the same data and make the
        same calls with the same arguments, and each returns the whole,
        replicated result.

        Rank c holds points ``[c L, (c + 1) L)``, L = n_l / D, of each task:
        its block of the first-column parts and the ytildes (``_fit_data``)
        and of the cross-kernel's columns (``get_xb_q``, natural order).  The
        transforms are ``parallel/mesh``'s sharded ones (kernel K4 on the
        block for the digital net, ``torch.fft`` for the lattice, then one
        ``reduce_scatter``), and the general solver (``_FastSolver``) serves
        every model:

        * the MLL, GCV and CV losses and their gradients: each sum over n is
          an all-reduce, so every rank holds the same loss;
        * several tasks: the residue blocks cross the ranks' frequency
          blocks, so each factorization and solve moves the tilde vectors
          into the residue layout and back, one ``all_to_all`` each way
          (``linalg/fast_solver``); the smallest task's n must split over the
          ranks;
        * serving: the mean sums the rank's columns of the cross-kernel
          against its coefficients, the variances and covariances take the
          quadratic form of the rank's columns, each followed by one
          all-reduce a query chunk; the query chunk size comes from the
          replicated n, so every rank runs the same chunks; ``coeffs`` is
          gathered whole; the cubature reads frequency 0 from the first rank
          (``fs.dc_block``) and sums the coefficients over the ranks.
        """
        self._seq_mesh, self._seq_axis = mesh, axis
        for cache in (self._ytilde_cache, self._ytilde_half_cache, self._ytilde_perm_cache,
                      self._k1parts_lam_cache, self._solver_cache, self._xbq_cache):
            cache.clear()
        self._coeffs_cache = None

    # -- concrete-model hooks -------------------------------------------
    def _ft(self, x):
        """The general solver's orthonormal transform of the last axis."""
        raise NotImplementedError

    def _ift(self, x):
        raise NotImplementedError

    # query-row transforms: ``pre_permuted`` rows are already in the model's
    # query column order (``_train_col_perm``), so a model may skip a gather;
    # the defaults ignore the flag
    def _ft_q(self, v, pre_permuted=False):
        return self._ft(v)

    def _ift_q(self, v, pre_permuted=False):
        return self._ift(v)

    def _point_class(self, task, n_l, r_l):
        """Class in [0, r_l) of each of the task's points among the r_l
        coupled frequencies (exact inverse diagonals)."""
        raise NotImplementedError

    def get_omega(self, m):
        """Twiddles of the radix-2 doubling merge from 2^m to 2^(m+1) points."""
        raise NotImplementedError

    def _ominus(self, a, b):
        raise NotImplementedError

    def _parts_from_delta(self, delta, beta, kappa):
        raise NotImplementedError

    def _part_dim(self, delta_j, j: int, b: int, k: int):
        """One dimension's series term; may depend on ``j`` only through
        ``self.alpha[j]`` (kernel_fused_scan evaluates one representative
        per group of dimensions)."""
        raise NotImplementedError

    def _ftout_dtype(self):
        raise NotImplementedError

    # models may provide a side-wise pair evaluator (see kernel_fused_scan)
    _part_dim_pair = None
    # whether the series is the lattice's Bernoulli one (kernel K5 on the card)
    _bernoulli_series = False

    def _get_k1parts_lam(self, l0, l1, n):
        """First-column parts in the (p0, p1, d, n) layout the solver's
        contraction reads (point axis last), cached per (l0, l1, n)."""
        key = (l0, l1, int(n))
        cached = self._k1parts_lam_cache.get(key)
        if cached is None:
            if self._seq_mesh is not None:
                cached = torch.movedim(self._k1parts_block(l0, l1, n), 0, -1).contiguous()
            else:
                cached = torch.movedim(self._get_k1parts(l0, l1, n), 0, -1).contiguous()
            self._k1parts_lam_cache[key] = cached
            if len(self._k1parts_lam_cache) > 24:
                self._k1parts_lam_cache.pop(next(iter(self._k1parts_lam_cache)))
        return cached

    def _ft_lam(self, k1):
        """Transform of first columns inside the general solver."""
        return self._ft(k1)

    _ft_lam_half = None  # lattice overrides with the rfft hooks
    _ft_lam_perm = None  # lattice overrides with the permuted-FFT hooks

    # -- caches ----------------------------------------------------------
    def _k1parts_block(self, l0, l1, n):
        """Under a sequence mesh: the first-column parts of this rank's block
        of the first n points only, (L, p0, p1, d), natural order."""
        xb0 = self._to_device(self._get_xxb(l0, n)[1][self._seq_block(n)])
        xb1 = self._to_device(self._get_xxb(l1, 1)[1][:1])
        return series.kernel_parts(self._parts_from_delta, xb0, xb1, self._ominus,
                                   self.derivatives[l0], self.derivatives[l1])

    def _get_k1parts(self, l0, l1, n):
        """Hyperparameter-independent first-column series terms, grown
        incrementally as n doubles."""
        key = (l0, l1)
        cur = self._k1parts_cache.get(key)
        have = 0 if cur is None else cur.shape[0]
        if n > have:
            xb0 = self._to_device(self._get_xxb(l0, n)[1][have:n])
            xb1 = self._to_device(self._get_xxb(l1, 1)[1][:1])
            new = series.kernel_parts(self._parts_from_delta, xb0, xb1, self._ominus,
                                      self.derivatives[l0], self.derivatives[l1])
            cur = new if cur is None else torch.cat([cur, new], 0)
            self._k1parts_cache[key] = cur
        return cur[:n]

    # -- half-spectrum (rfft) and permuted-spectrum paths ---------------
    def _use_half_spectrum(self, n) -> bool:
        """rfft single-task solver: a model with the half-transform hooks, one
        task, n >= 2, no sequence mesh (the sharded transforms are full
        spectrum), the dense debug oracle off (it checks the general
        solver)."""
        if self._ft_lam_half is None or self.num_tasks != 1 or self._seq_mesh is not None:
            return False
        return int(np.asarray(n)[0]) >= 2 and not debug_checks_enabled()

    def _use_perm_spectrum(self, n) -> bool:
        """Permuted-spectrum solver (kernels K1-K3): CUDA float32, one task, a
        supported n, no sequence mesh, the dense debug oracle off.
        ``FASTGPS_TORCH_FORCE_PERM=1`` takes it on the CPU too (in float32),
        where the plain kernel versions run."""
        if self._ft_lam_perm is None or self.num_tasks != 1 or self._seq_mesh is not None:
            return False
        if not perm_fft.supported(int(np.asarray(n)[0])):
            return False
        if self.dtype != torch.float32 or debug_checks_enabled():
            return False
        return self.device.type == "cuda" or os.environ.get("FASTGPS_TORCH_FORCE_PERM") == "1"

    def _get_ytilde(self, task, n):
        """``_ft`` of the observations (the general solver's ytilde).

        Incremental doubling: when ``ft(y[:n/2])`` is cached, ``ft(y[:n])`` is
        the one-level radix-2 merge of it with ``ft(y[n/2:n])`` -- a half-size
        transform and an O(n) merge instead of a full-size transform.  Under a
        sequence mesh: this rank's block of the sharded transform, no merge."""
        key = (task, n)
        if key not in self._ytilde_cache:
            y = self._y[task]
            prev = self._ytilde_cache.get((task, n // 2))
            if self._seq_mesh is not None:
                yt = self._ft(y[..., self._seq_block(n)])
            elif n > 1 and prev is not None:
                half = y[..., n // 2:n]
                half_t = self._ft(half) if n // 2 > 1 else half.to(self._ftout_dtype())
                yt = tr.merge_doubling(prev, half_t, self.get_omega(log2_int(n // 2)))
            else:
                yt = self._ft(y[..., :n]) if n > 1 else y[..., :n].to(self._ftout_dtype())
            self._ytilde_cache[key] = yt
        return self._ytilde_cache[key]

    def _get_ytilde_half(self, task, n):
        """rfft of the observations (the half-spectrum solver's ytilde)."""
        key = (task, n)
        if key not in self._ytilde_half_cache:
            self._ytilde_half_cache[key] = self._ft_half(self._y[task][..., :n])
        return self._ytilde_half_cache[key]

    def _get_ytilde_perm(self, task, n):
        """Permuted-spectrum ytilde (one K1 launch when first built)."""
        key = (task, n)
        if key not in self._ytilde_perm_cache:
            self._ytilde_perm_cache[key] = self._ft_perm(self._y[task][..., :n])
        return self._ytilde_perm_cache[key]

    def _on_data_change(self):
        # y only grows by appending, so ytilde entries for prefix sizes stay valid
        for cache in (self._ytilde_cache, self._ytilde_half_cache, self._ytilde_perm_cache):
            for (task, n) in list(cache):
                if n > self._y[task].shape[-1]:
                    del cache[(task, n)]
        self._solver_cache.clear()

    # -- solver ----------------------------------------------------------
    def _solver(self, n=None):
        n = self._norm_n(n) if n is not None else self.n.copy()
        if not _all_pow2(n):
            raise ValueError("fast GPs require power-of-two sample counts")
        key = (self._version, tuple(int(v) for v in n))
        if key not in self._solver_cache:
            self._warm_k1parts(n)
            solver = make_solver(self, self._raw_dict(), n)
            if debug_checks_enabled():
                from ..utils.debug import check_fast_solver
                check_fast_solver(self, solver)
            self._solver_cache[key] = solver
            if len(self._solver_cache) > 8:
                self._solver_cache.pop(next(iter(self._solver_cache)))
        return self._solver_cache[key]

    def _pair_consts(self, a, b, dtype):
        """``series.pair_consts`` of original tasks ``a`` and ``b`` on the
        model's device, built once."""
        key = (a, b, dtype)
        if key not in self._pair_consts_cache:
            self._pair_consts_cache[key] = series.pair_consts(
                self.derivatives[a], self.derivatives[b], self.derivatives_coeffs[a],
                self.derivatives_coeffs[b], dtype, self.device)
        return self._pair_consts_cache[key]

    def _warm_k1parts(self, n):
        for _, _, a, b, nlen in _sorted_pairs(fs.sort_tasks(n)[0], n):
            self._get_k1parts_lam(a, b, nlen)

    def _warm_for_fit(self):
        self._fit_data()

    def _warm_extra(self, n):
        # future-n queries need first-column caches at the projected sizes
        self._warm_k1parts(np.asarray(n, dtype=np.int64))

    def _query_solver_any(self, raw, n):
        return make_solver(self, raw, np.asarray(n, dtype=np.int64))

    def _fit_data(self):
        """``(k1parts, ytildes)``: the data the loss reads, from the caches
        (built on first use): the parts of every sorted task pair, and the
        ytilde leg in the chosen solver's form (permuted, half or full
        spectrum; one a task)."""
        pairs = _sorted_pairs(fs.sort_tasks(self.n)[0], self.n)
        k1parts = tuple(self._get_k1parts_lam(a, b, nlen) for _, _, a, b, nlen in pairs)
        n0 = int(self.n[0])
        if self._use_perm_spectrum(self.n):
            yts = (self._get_ytilde_perm(0, n0),)
        elif self._use_half_spectrum(self.n):
            yts = (self._get_ytilde_half(0, n0),)
        else:
            yts = tuple(self._get_ytilde(l, int(self.n[l])) for l in range(self.num_tasks))
        return k1parts, yts

    def _solver_pure(self, raw, data=None):
        return make_solver(self, raw, self.n, data=data)

    # -- data ingestion guards -------------------------------------------
    def get_x_next(self, n, task=None):
        n_arr = np.asarray([n] if isinstance(n, (int, np.integer)) else n, dtype=np.int64)
        if not _all_pow2(n_arr):
            raise ValueError("sample sizes must be powers of 2")
        return super().get_x_next(n, task=task)

    def add_y_next(self, y_next, task=None):
        super().add_y_next(y_next, task=task)
        if not _all_pow2(self.n):
            raise ValueError("total samples must be powers of 2")

    def _norm_n(self, n):
        n = super()._norm_n(n)
        if not _all_pow2(n):
            raise ValueError("n must be powers of 2 >= current sample counts")
        return n

    def _query_itemsize(self):
        # the transform's output type: complex FFT buffers (2x real) for the
        # lattice, real FWHT buffers for the digital net
        return torch.empty((), dtype=self._ftout_dtype()).element_size()

    # -- kernel evaluation ----------------------------------------------
    def _kernel_explicit(self, x0, x1, beta0, beta1, c0, c1, scale, lengthscales, factor=None):
        # live buffers are O(N * n) whatever d is: never (N, n, d)
        return series.kernel_fused_scan(self._part_dim, x0, x1, self._ominus,
                                        beta0, beta1, c0, c1, scale, lengthscales,
                                        self.alpha, part_dim_pair_fn=self._part_dim_pair,
                                        bernoulli=self._bernoulli_series, factor=factor)

    # -- fast cubature ---------------------------------------------------
    def post_cubature_mean(self, task=None):
        """Closed-form posterior mean of the integral over [0,1]^d: the kernels
        integrate to ``scale``, so only the DC part of the coefficients
        survives (under a sequence mesh each rank sums its coefficients, then
        one all-reduce)."""
        kmat_tasks = self.gram_matrix_tasks
        coeffs = self._coeffs_local()
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        offs = np.concatenate([[0], np.cumsum(self._cols(self.n))])
        tidx = torch.as_tensor(task, device=self.device)
        pieces = []
        for l in range(self.num_tasks):
            cl = (self.scale * coeffs[..., offs[l]:offs[l + 1]])[..., None, :]
            pieces.append(cl * kmat_tasks[..., tidx, l, None])
        pcmean = comm.all_sum(torch.cat(pieces, -1).sum(-1), self._seq_group)
        return pcmean[..., 0] if inttask else pcmean

    def _cubature_quad_term(self, solver, taskL, taskR):
        """(..., TL, TR) quadratic correction from the DC inverse block."""
        kmat_tasks = self.gram_matrix_tasks
        inv_cut = solver.dc_block()  # (..., T, T) sorted order
        to = torch.as_tensor(list(solver.task_order), device=self.device)
        nord = np.asarray(solver.n_sorted, dtype=np.float64)
        nsqrts = torch.as_tensor(np.sqrt(nord[:, None] * nord[None, :]),
                                 dtype=inv_cut.abs().dtype, device=self.device)
        cdt = inv_cut.dtype
        tl = torch.as_tensor(taskL, device=self.device)
        tr = torch.as_tensor(taskR, device=self.device)
        kl = kmat_tasks[..., tl, :][..., :, to].to(cdt)
        kr = kmat_tasks[..., to, :][..., :, tr].to(cdt)
        return torch.real(torch.einsum("...ij,...jk,...kl->...il", kl, nsqrts * inv_cut, kr))

    def post_cubature_var(self, task=None, n=None):
        """Posterior cubature variance."""
        n = self._norm_n(n)
        solver = self._solver(n)
        kmat_tasks = self.gram_matrix_tasks
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        term = torch.diagonal(self._cubature_quad_term(solver, task, task), dim1=-2, dim2=-1)
        tidx = torch.as_tensor(task, device=self.device)
        pcvar = self.scale * kmat_tasks[..., tidx, tidx] - self.scale ** 2 * term
        pcvar = torch.clamp(pcvar, min=0.0)
        return pcvar[..., 0] if inttask else pcvar

    def post_cubature_cov(self, task0=None, task1=None, n=None):
        """Posterior cubature covariance between tasks, (..., T0, T1); its
        diagonal clamped at 0 when the two task lists are equal."""
        n = self._norm_n(n)
        solver = self._solver(n)
        kmat_tasks = self.gram_matrix_tasks
        task0 = self.default_task if task0 is None else task0
        task1 = self.default_task if task1 is None else task1
        task0, inttask0 = _as_task_array(task0, self.num_tasks)
        task1, inttask1 = _as_task_array(task1, self.num_tasks)
        term = self._cubature_quad_term(solver, task0, task1)
        t0 = torch.as_tensor(task0, device=self.device)
        t1 = torch.as_tensor(task1, device=self.device)
        prior = kmat_tasks[..., t0, :][..., :, t1]
        pccov = self.scale[..., None] * prior - self.scale[..., None] ** 2 * term
        if np.array_equal(task0, task1):
            pccov = pccov.clone()
            pccov.diagonal(dim1=-2, dim2=-1).clamp_(min=0.0)
        if inttask0 and inttask1:
            return pccov[..., 0, 0]
        if inttask0:
            return pccov[..., 0, :]
        if inttask1:
            return pccov[..., :, 0]
        return pccov


def _all_pow2(n):
    n = np.asarray(n)
    return bool(np.logical_or(n == 0, (n & (n - 1)) == 0).all())
