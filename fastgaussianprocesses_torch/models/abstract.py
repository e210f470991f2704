"""Shared GP engine: parameters, data ingestion, the fit loop, posterior
queries (counterpart of ``fastgaussianprocesses_tpu/models/abstract.py``).

The model object owns the hyperparameters, the data on its device and the
host-side geometry caches.  PyTorch runs eagerly, so the JAX package's
per-signature ``jit`` cache has no counterpart: each query runs its chunks
in a Python loop, and each fit step is the loss, its gradient by
``torch.autograd.grad`` and an Rprop update, launched from Python.
"""

import math

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..fit.rprop import rprop_init, rprop_update
from ..parallel import comm
from .params import IDENTITY, LOG_EXP, make_param


def _as_task_array(task, num_tasks):
    """Normalize a task argument to (array, was_int)."""
    inttask = isinstance(task, (int, np.integer))
    task = np.asarray([task] if inttask else task, dtype=np.int64)
    if task.ndim != 1 or not ((task >= 0) & (task < num_tasks)).all():
        raise ValueError(f"invalid task index {task} for {num_tasks} tasks")
    return task, inttask


def norm_ppf(q):
    """Standard normal quantile, on the host (``scipy.special.ndtri``)."""
    from scipy.special import ndtri
    return float(ndtri(float(q)))


def _check_confidence(confidence):
    if not 0 < confidence < 1:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    return norm_ppf(1 - (1 - confidence) / 2)


# steps a block of fit(steps_per_dispatch=-1) runs at most (the JAX package's B)
FUSED_BLOCK = 64


def _cat(ts, dim):
    """``torch.cat`` without the copy of a one-tensor list (a query chunk's
    cross-kernel is ~250 MB at n = 2^20)."""
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim)


class AbstractGP:
    """Base class; concrete models provide sampling, kernels and solvers."""

    # the sequence mesh and its axis (fast models, ``use_sequence_sharding``)
    _seq_mesh = None
    _seq_axis = "seq"

    @property
    def _seq_group(self):
        """The process group that splits the transform axis n, or None (also
        for a mesh axis of size 1, which needs no collective)."""
        if self._seq_mesh is None:
            return None
        from ..parallel.mesh import axis_group
        return axis_group(self._seq_mesh, self._seq_axis)

    def _seq_block(self, n):
        """This rank's slice of a length-n axis under the sequence mesh."""
        from ..parallel.mesh import seq_sharding_for
        sh = seq_sharding_for(1, self._seq_mesh, self._seq_axis)
        if n % sh.size:
            raise ValueError(f"n = {n} does not split over the {sh.size} ranks of the "
                             f"sequence mesh")
        L = n // sh.size
        return slice(sh.rank * L, (sh.rank + 1) * L)

    def _cols(self, n):
        """The training columns this rank holds of each task at sample counts
        ``n``: all of them, or under a sequence mesh the rank's block of each
        (``n_l / D`` points, natural order)."""
        n = np.asarray(n, dtype=np.int64)
        if self._seq_mesh is None:
            return n
        blocks = [self._seq_block(int(v)) for v in n]
        return np.asarray([b.stop - b.start for b in blocks], dtype=np.int64)

    def _gather_cols(self, x, n):
        """The whole vectors from every rank's blocks ``x`` (task blocks along
        the last axis, ``_cols(n)``), task after task (identity without a
        mesh)."""
        if self._seq_mesh is None:
            return x
        group = self._seq_group
        parts = torch.split(x, [int(v) for v in self._cols(n)], -1)
        return _cat([comm.all_gather_cat(p.contiguous(), group, -1) for p in parts], -1)

    def __init__(self,
                 seqs,
                 num_tasks=None,
                 scale=1.0,
                 lengthscales=1.0,
                 noise=1e-8,
                 factor_task_kernel=1.0,
                 rank_factor_task_kernel=None,
                 noise_task_kernel=1.0,
                 tfs_scale=LOG_EXP,
                 tfs_lengthscales=LOG_EXP,
                 tfs_noise=LOG_EXP,
                 tfs_factor_task_kernel=IDENTITY,
                 tfs_noise_task_kernel=LOG_EXP,
                 requires_grad_scale=True,
                 requires_grad_lengthscales=True,
                 requires_grad_noise=False,
                 requires_grad_factor_task_kernel=None,
                 requires_grad_noise_task_kernel=None,
                 shape_batch=(),
                 shape_scale=(1,),
                 shape_lengthscales=None,
                 shape_noise=(1,),
                 shape_factor_task_kernel=None,
                 shape_noise_task_kernel=None,
                 derivatives=None,
                 derivatives_coeffs=None,
                 adaptive_nugget=False,
                 dtype=None,
                 device=None):
        if num_tasks is None:
            self.solo_task = True
            self.default_task = 0
            num_tasks = 1
        else:
            if not (isinstance(num_tasks, int) and num_tasks > 0):
                raise ValueError("num_tasks must be a positive int")
            self.solo_task = False
            self.default_task = np.arange(num_tasks)
        self.num_tasks = num_tasks
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else default_dtype(self.device)
        if len(seqs) != num_tasks:
            raise ValueError(f"need {num_tasks} sequence generators")
        self.seqs = list(seqs)
        self.d = self.seqs[0].d
        if not all(s.d == self.d for s in self.seqs):
            raise ValueError("all sequences need the same dimension")
        self.n = np.zeros(num_tasks, dtype=np.int64)
        # derivative mode pins the task kernel to the all-ones rank-1 Gram
        if derivatives is not None or derivatives_coeffs is not None:
            rank_factor_task_kernel = 1
            tfs_noise_task_kernel = IDENTITY
            noise_task_kernel = 0.0
        if derivatives is None:
            derivatives = [np.zeros((1, self.d), dtype=np.int64) for _ in range(num_tasks)]
        if isinstance(derivatives, np.ndarray):
            derivatives = [derivatives]
        derivatives = [np.atleast_2d(np.asarray(dv, dtype=np.int64)) for dv in derivatives]
        if len(derivatives) != num_tasks or not all(
                dv.ndim == 2 and dv.shape[1] == self.d for dv in derivatives):
            raise ValueError("derivatives: one (p, d) int array per task")
        self.derivatives = derivatives
        if derivatives_coeffs is None:
            derivatives_coeffs = [np.ones(len(dv)) for dv in derivatives]
        derivatives_coeffs = [np.asarray(c, dtype=np.float64) for c in derivatives_coeffs]
        if not all(c.shape == (len(dv),) for c, dv in zip(derivatives_coeffs, derivatives)):
            raise ValueError("derivatives_coeffs: one coefficient per derivative row")
        self.derivatives_coeffs = derivatives_coeffs
        self._has_derivatives = any((dv > 0).any() or (c != 1).any()
                                    for dv, c in zip(derivatives, derivatives_coeffs))
        self.shape_batch = tuple(shape_batch)
        self.ndim_batch = len(self.shape_batch)
        if shape_lengthscales is None:
            shape_lengthscales = (self.d,)
        if shape_factor_task_kernel is None:
            if rank_factor_task_kernel is None:
                rank_factor_task_kernel = 0 if num_tasks == 1 else 1
            if not 0 <= rank_factor_task_kernel <= num_tasks:
                raise ValueError("rank_factor_task_kernel out of range")
            shape_factor_task_kernel = (num_tasks, rank_factor_task_kernel)
        if shape_noise_task_kernel is None:
            shape_noise_task_kernel = (num_tasks,)
        if requires_grad_factor_task_kernel is None:
            requires_grad_factor_task_kernel = num_tasks > 1
        if requires_grad_noise_task_kernel is None:
            requires_grad_noise_task_kernel = num_tasks > 1
        if self._has_derivatives:
            requires_grad_factor_task_kernel = requires_grad_noise_task_kernel = False
        sb, dt, dev = self.shape_batch, self.dtype, self.device
        self.params = {
            "scale": make_param("scale", scale, shape_scale, tfs_scale, requires_grad_scale,
                                sb, 1, dt, dev),
            "lengthscales": make_param("lengthscales", lengthscales, shape_lengthscales,
                                       tfs_lengthscales, requires_grad_lengthscales,
                                       sb, 1, dt, dev),
            "noise": make_param("noise", noise, shape_noise, tfs_noise, requires_grad_noise,
                                sb, 1, dt, dev),
            "factor_task_kernel": make_param("factor_task_kernel", factor_task_kernel,
                                             shape_factor_task_kernel, tfs_factor_task_kernel,
                                             requires_grad_factor_task_kernel,
                                             sb, 2, dt, dev, positive=False),
            "noise_task_kernel": make_param("noise_task_kernel", noise_task_kernel,
                                            shape_noise_task_kernel, tfs_noise_task_kernel,
                                            requires_grad_noise_task_kernel,
                                            sb, 1, dt, dev, positive=True, allow_nonneg=True),
        }
        if self.params["scale"].raw.shape[-1] != 1 or self.params["noise"].raw.shape[-1] != 1:
            raise ValueError("scale and noise need a trailing dimension of 1")
        if self.params["lengthscales"].raw.shape[-1] not in (1, self.d):
            raise ValueError("lengthscales need a trailing dimension of 1 or d")
        if self._has_derivatives:
            if not torch.allclose(self.gram_matrix_tasks.cpu(),
                                  torch.ones((), dtype=self.dtype)):
                raise ValueError("derivative mode requires an all-ones task Gram")
        # scale each task's noise by its Gram trace relative to task 0's
        self.adaptive_nugget = bool(adaptive_nugget)
        self._y = [torch.zeros(self.shape_batch + (0,), dtype=dt, device=dev)
                   for _ in range(num_tasks)]
        self._x_cache = [None] * num_tasks   # numpy float points
        self._xb_cache = [None] * num_tasks  # numpy binary/int or alias of float
        self._version = 0  # bumped on any parameter change
        self._coeffs_cache = None  # ((version, n_tuple), coeffs)
        self._xbq_cache = {}       # (task, n) -> query-ordered training cols on device

    # ------------------------------------------------------------------
    # parameter access
    # ------------------------------------------------------------------
    @property
    def scale(self):
        return self.params["scale"].value

    @property
    def lengthscales(self):
        return self.params["lengthscales"].value

    @property
    def noise(self):
        return self.params["noise"].value

    @property
    def factor_task_kernel(self):
        return self.params["factor_task_kernel"].value

    @property
    def noise_task_kernel(self):
        return self.params["noise_task_kernel"].value

    @property
    def gram_matrix_tasks(self):
        """Task Gram ``F F^T + diag(v)``."""
        return self._task_gram(self._raw_dict())

    def _task_gram(self, raw):
        f = self.params["factor_task_kernel"].from_raw(raw["factor_task_kernel"])
        v = self.params["noise_task_kernel"].from_raw(raw["noise_task_kernel"])
        kmat = torch.einsum("...il,...kl->...ik", f, f)
        return kmat + v[..., None] * torch.eye(self.num_tasks, dtype=self.dtype,
                                               device=self.device)

    def _transformed(self, raw):
        return {k: self.params[k].from_raw(raw[k]) for k in raw}

    def _raw_dict(self):
        return {k: p.raw for k, p in self.params.items()}

    def _set_raw(self, raw):
        for k, v in raw.items():
            self.params[k] = self.params[k]._replace(raw=v)
        self._version += 1

    @property
    def total_parameters(self):
        return sum(p.raw.numel() for p in self.params.values())

    @property
    def total_tuneable_parameters(self):
        """Entries of the parameters that ``fit`` trains."""
        return sum(p.raw.numel() for p in self.params.values() if p.trainable)

    @property
    def m(self):
        return np.where(self.n == 0, -1, np.log2(np.maximum(self.n, 1)).astype(np.int64))

    # ------------------------------------------------------------------
    # point/data management
    # ------------------------------------------------------------------
    def _get_xxb(self, task: int, n: int):
        """Grow and slice the cached point sequence for one task."""
        cur = 0 if self._x_cache[task] is None else self._x_cache[task].shape[0]
        if n > cur:
            x_new, xb_new = self._sample(self.seqs[task], cur, n)
            if self._x_cache[task] is None:
                self._x_cache[task], self._xb_cache[task] = x_new, xb_new
            else:
                self._x_cache[task] = np.concatenate([self._x_cache[task], x_new], 0)
                if xb_new is x_new:
                    self._xb_cache[task] = self._x_cache[task]
                else:
                    self._xb_cache[task] = np.concatenate([self._xb_cache[task], xb_new], 0)
        return self._x_cache[task][:n], self._xb_cache[task][:n]

    def _to_device(self, a):
        """Host array -> device tensor (floating arrays in the model dtype)."""
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, device=self.device).to(self.dtype)
        return torch.as_tensor(a, device=self.device)

    def get_x(self, task: int, n=None):
        if n is None:
            n = self.n[task]
        return self._to_device(self._get_xxb(task, int(n))[0])

    def get_xb(self, task: int, n=None):
        if n is None:
            n = self.n[task]
        return self._to_device(self._get_xxb(task, int(n))[1])

    @property
    def x(self):
        xs = [self.get_x(l) for l in range(self.num_tasks)]
        return xs[0] if self.solo_task else xs

    @property
    def y(self):
        return self._y[0] if self.solo_task else self._y

    def _next_host(self, n, task):
        if isinstance(n, (int, np.integer)):
            n = [int(n)]
        n = np.asarray(n, dtype=np.int64)
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        if n.shape != task.shape or not (n >= self.n[task]).all():
            raise ValueError("n must match task and be >= current sample counts")
        xs = [self._get_xxb(int(l), int(n[i]))[0][self.n[l]:] for i, l in enumerate(task)]
        return xs, inttask

    def get_x_next(self, n, task=None):
        """Next sampling locations, as tensors on the model's device."""
        xs, inttask = self._next_host(n, task)
        xs = [self._to_device(x) for x in xs]
        return xs[0] if inttask else xs

    def get_x_next_host(self, n, task=None):
        """``get_x_next`` as host numpy arrays (no device transfer)."""
        xs, inttask = self._next_host(n, task)
        xs = [np.asarray(x) for x in xs]
        return xs[0] if inttask else xs

    def add_y_next(self, y_next, task=None):
        """Ingest new observations (tensors or arrays, appended per task)."""
        if isinstance(y_next, (torch.Tensor, np.ndarray)):
            y_next = [y_next]
        if task is None:
            task = self.default_task
        task, _ = _as_task_array(task, self.num_tasks)
        if len(y_next) != len(task):
            raise ValueError("one observation array per task")
        for i, l in enumerate(task):
            yi = torch.as_tensor(y_next[i], device=self.device).to(self.dtype)
            if tuple(yi.shape[:-1]) != self.shape_batch:
                raise ValueError(f"y batch shape {tuple(yi.shape[:-1])} != "
                                 f"shape_batch {self.shape_batch}")
            self._y[l] = torch.cat([self._y[l], yi], -1)
        self.n = np.array([self._y[l].shape[-1] for l in range(self.num_tasks)], dtype=np.int64)
        self._coeffs_cache = None
        self._on_data_change()

    def _on_data_change(self):
        pass

    def kernel(self, x, z, beta0=None, beta1=None, c0=None, c1=None):
        """The model's kernel between point arrays ``x`` and ``z``
        (broadcasting their leading dims), of the derivative orders ``beta0``
        / ``beta1`` weighted by ``c0`` / ``c1`` (default: no derivative)."""
        x, z = (torch.as_tensor(v, device=self.device) for v in (x, z))
        x, z = (v.to(self.dtype) if v.is_floating_point() else v for v in (x, z))
        beta0, beta1 = (np.atleast_2d(np.asarray(np.zeros((1, self.d)) if b is None else b,
                                                 dtype=np.int64)) for b in (beta0, beta1))
        c0 = np.ones(len(beta0)) if c0 is None else np.asarray(c0)
        c1 = np.ones(len(beta1)) if c1 is None else np.asarray(c1)
        return self._kernel_explicit(x, z, beta0, beta1, c0, c1, self.scale, self.lengthscales)

    # ------------------------------------------------------------------
    # solver plumbing (provided by concrete models)
    # ------------------------------------------------------------------
    def _solver(self, n=None):
        raise NotImplementedError

    def _sample(self, seq, n_min, n_max):
        x = seq(n_min, n_max)
        return x, x

    def _kernel_explicit(self, x0, x1, beta0, beta1, c0, c1, scale, lengthscales, factor=None):
        """The kernel of ``x0`` against ``x1`` (broadcasting), times ``factor``
        where given (a task factor, broadcastable against the result)."""
        raise NotImplementedError

    def _query_solver_any(self, raw, n):
        """Fresh solver for sample counts ``n`` from explicit raw params."""
        raise NotImplementedError

    def _warm_for_fit(self):
        pass

    def _warm_for_query(self, n):
        """Materialize host and device caches before a query."""
        for l in range(self.num_tasks):
            self._get_xxb(l, int(n[l]))
        self._warm_for_fit()
        self._warm_extra(n)

    def _warm_extra(self, n):
        pass

    # ------------------------------------------------------------------
    # coefficients
    # ------------------------------------------------------------------
    @property
    def coeffs(self):
        r"""Coefficients $K^{-1} y$ (cached per parameter version and n); under
        a sequence mesh the whole vector on every rank."""
        return self._gather_cols(self._coeffs_local(), self.n)

    def _coeffs_local(self):
        """The coefficients of this rank's training columns (``_cols``)."""
        key = (self._version, tuple(self.n.tolist()))
        if self._coeffs_cache is None or self._coeffs_cache[0] != key:
            self._warm_for_query(self.n)
            coeffs = self._query_solver_any(self._raw_dict(), self.n).coeffs()
            self._coeffs_cache = (key, coeffs)
        return self._coeffs_cache[1]

    # ------------------------------------------------------------------
    # posterior queries
    # ------------------------------------------------------------------
    def _norm_n(self, n):
        if n is None:
            n = self.n
        if isinstance(n, (int, np.integer)):
            n = np.asarray([n] * self.num_tasks if self.num_tasks > 1 else [n], dtype=np.int64)
        n = np.asarray(n, dtype=np.int64)
        if n.shape != (self.num_tasks,) or not (n >= self.n).all():
            raise ValueError("n needs one entry per task, each >= the current count")
        return n

    # -- query column ordering ------------------------------------------
    # Models may declare a per-task permutation of the TRAINING columns for
    # cross-kernel queries (lattice: bit-reversed order, so the per-chunk
    # solver transform needs no gather along the long axis).  The solver is
    # told via pre_permuted=...; solve outputs come back in the same order,
    # consistent because every contraction pairs them with equally-permuted
    # kmat columns (and the posterior-mean coeffs are permuted once).
    def _train_col_perm(self, l: int, n: int):
        return None

    def _query_pre_permuted(self, n) -> bool:
        return all(self._train_col_perm(l, int(n[l])) is not None
                   for l in range(self.num_tasks))

    def get_xb_q(self, l: int, n: int):
        """Training columns for queries, in the model's query column order
        (cached on the device: at n = 2^20, d = 8 one copy is 32 MB, and each
        query chunk reads it); under a sequence mesh the rank's block of
        them, in natural order."""
        key = (l, int(n))
        cached = self._xbq_cache.get(key)
        if cached is None:
            xb = np.asarray(self._get_xxb(l, int(n))[1])
            perm = self._train_col_perm(l, int(n))
            if self._seq_mesh is not None:
                xb = xb[self._seq_block(int(n))]
            cached = self._to_device(xb if perm is None else xb[np.asarray(perm)])
            self._xbq_cache[key] = cached
            while len(self._xbq_cache) > 4:
                self._xbq_cache.pop(next(iter(self._xbq_cache)))
        return cached

    def _query_col_index(self, n):
        """Concatenated column permutation over tasks (for permuting the
        natural-order coeffs vector once per query)."""
        offs = np.concatenate([[0], np.cumsum(n)])
        idx = [offs[l] + np.asarray(self._train_col_perm(l, int(n[l])))
               for l in range(self.num_tasks)]
        return np.concatenate(idx)

    def _cross_kmat(self, x, task, n, params, kmat_tasks):
        """(..., T, N, sum n_l) cross-covariance against the training set
        (columns in the model's query column order; under a sequence mesh
        the rank's columns, ``_cols(n)``)."""
        scale, ls = params["scale"], params["lengthscales"]
        rows = []
        for t in task:
            cols = []
            for l1 in range(self.num_tasks):
                xb1 = self.get_xb_q(l1, n=n[l1])
                cols.append(self._kernel_explicit(x[:, None, :], xb1[None, :, :],
                                                  self.derivatives[t], self.derivatives[l1],
                                                  self.derivatives_coeffs[t],
                                                  self.derivatives_coeffs[l1], scale, ls,
                                                  factor=kmat_tasks[..., t, l1, None, None]))
            rows.append(_cat(cols, -1)[..., None, :, :])
        return _cat(rows, -3)

    # Live-temp budget for one (query x train) cross-kernel chunk, as in the
    # JAX package: LIVE_FACTOR buffers of nb * total_n elements of the
    # model's query itemsize.  At n = 2^20 float32 (complex64 itemsize 8)
    # this gives nb = 59 query rows a chunk, ~250 MB per (nb, n) buffer.
    _QUERY_CHUNK_BYTES = 3_000_000_000
    _QUERY_LIVE_FACTOR = 6

    def _query_itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def _query_chunk_size(self, N: int, total_n: int) -> int:
        """Query rows a chunk for ``total_n`` training columns (a rank's under a
        sequence mesh, which every rank computes alike from the replicated n,
        so that all run the same number of chunks and collectives)."""
        per_row = self._QUERY_LIVE_FACTOR * max(total_n, 1) * self._query_itemsize()
        return int(max(1, min(N, self._QUERY_CHUNK_BYTES // per_row)))

    @staticmethod
    def _map_query_chunks(per_chunk, x, nb, dim=-1):
        """``per_chunk(xq_block)`` over query chunks of ``nb`` rows, results
        concatenated along ``dim`` (the axis of the chunk's rows)."""
        if nb >= x.shape[0]:
            return per_chunk(x)
        return torch.cat([per_chunk(x[i:i + nb]) for i in range(0, x.shape[0], nb)], dim)

    def _query_points(self, x):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"query points need shape (N, {self.d})")
        return x

    def _prior_diag(self, xc, task, params, kmat_tasks):
        scale, ls = params["scale"], params["lengthscales"]
        return torch.stack([
            self._kernel_explicit(xc, xc, self.derivatives[t], self.derivatives[t],
                                  self.derivatives_coeffs[t], self.derivatives_coeffs[t], scale,
                                  ls, factor=kmat_tasks[..., t, t, None])
            for t in task], -2)

    def post_mean(self, x, task=None):
        """Posterior mean."""
        x = self._query_points(x)
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        self._warm_for_query(self.n)
        nb = self._query_chunk_size(x.shape[0], int(self._cols(self.n).sum()))
        raw = self._raw_dict()
        params = self._transformed(raw)
        kmat_tasks = self._task_gram(raw)
        coeffs = self._query_solver_any(raw, self.n).coeffs()
        if self._query_pre_permuted(self.n):  # match the kmat column order
            coeffs = coeffs[..., torch.as_tensor(self._query_col_index(self.n),
                                                 device=self.device)]
        group = self._seq_group

        def one(xc):
            kmat = self._cross_kmat(xc, task, self.n, params, kmat_tasks)
            # under a sequence mesh each rank sums its columns, then one all-reduce
            return comm.all_sum(torch.matmul(kmat, coeffs[..., None, :, None])[..., 0], group)

        pmean = self._map_query_chunks(one, x, nb)
        return pmean[..., 0, :] if inttask else pmean

    def post_var(self, x, task=None, n=None):
        """Posterior variance; ``n`` projects it to future sample counts."""
        x = self._query_points(x)
        n = self._norm_n(n)
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        self._warm_for_query(n)
        nb = self._query_chunk_size(x.shape[0], int(self._cols(n).sum()))
        pp = self._query_pre_permuted(n)
        raw = self._raw_dict()
        params = self._transformed(raw)
        kmat_tasks = self._task_gram(raw)
        solver = self._query_solver_any(raw, n)  # factorized once

        def one(xc):
            prior = self._prior_diag(xc, task, params, kmat_tasks)
            kmat = self._cross_kmat(xc, task, n, params, kmat_tasks)
            # quadratic form entirely in tilde space (Parseval)
            diag = prior - solver.gram_quad_diag(kmat, extra_ndim=2, pre_permuted=pp)
            return torch.clamp(diag, min=0.0)

        diag = self._map_query_chunks(one, x, nb)
        return diag[..., 0, :] if inttask else diag

    def post_mean_var(self, x, task=None, n=None):
        """Posterior mean and variance in ONE pass over the cross-kernel.

        ``n`` projects the VARIANCE to a future sample size (the mean always
        uses the data at the current n).  Returns ``(pmean, pvar)``.
        """
        x = self._query_points(x)
        n = self._norm_n(n)
        same_n = tuple(n.tolist()) == tuple(self.n.tolist())
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        self._warm_for_query(n)
        nb = self._query_chunk_size(x.shape[0], int(self._cols(n).sum()))
        pp = self._query_pre_permuted(n)
        raw = self._raw_dict()
        params = self._transformed(raw)
        kmat_tasks = self._task_gram(raw)
        solver = self._query_solver_any(raw, n)
        solver_mean = solver if same_n else self._query_solver_any(raw, self.n)
        coeffs = solver_mean.coeffs()
        group = self._seq_group
        sel = None
        if self._seq_mesh is not None:
            # the kmat columns are the rank's blocks of the n-sized training
            # sets: pair them with the coefficients of those points, 0 past
            # the current n
            if not same_n:
                whole = torch.split(self._gather_cols(coeffs, self.n),
                                    [int(v) for v in self.n], -1)
                coeffs = _cat([torch.nn.functional.pad(c, (0, int(n[l]) - int(self.n[l])))
                               [..., self._seq_block(int(n[l]))]
                               for l, c in enumerate(whole)], -1)
        else:
            # kmat columns are in the model's query order for the n-sized
            # training sets; the MEAN pairs the current-n subset of them with
            # the equally-reordered coeffs
            offs_n = np.concatenate([[0], np.cumsum(n)])
            offs_c = np.concatenate([[0], np.cumsum(self.n)])
            sel_cols, coef_cols = [], []
            for l in range(self.num_tasks):
                perm = self._train_col_perm(l, int(n[l]))
                order = np.asarray(perm) if perm is not None else np.arange(int(n[l]))
                mask = order < self.n[l]
                sel_cols.append(offs_n[l] + np.nonzero(mask)[0])
                coef_cols.append(offs_c[l] + order[mask])
            sel_cols = np.concatenate(sel_cols)
            coef_cols = np.concatenate(coef_cols)
            sel_identity = same_n and bool(np.array_equal(sel_cols, np.arange(int(n.sum()))))
            coef_identity = bool(np.array_equal(coef_cols, np.arange(int(self.n.sum()))))
            if not coef_identity:
                coeffs = coeffs[..., torch.as_tensor(coef_cols, device=self.device)]
            sel = None if sel_identity else torch.as_tensor(sel_cols, device=self.device)

        def one(xc):
            prior = self._prior_diag(xc, task, params, kmat_tasks)
            kmat = self._cross_kmat(xc, task, n, params, kmat_tasks)
            var = torch.clamp(prior - solver.gram_quad_diag(kmat, extra_ndim=2,
                                                            pre_permuted=pp), min=0.0)
            km = kmat if sel is None else kmat[..., sel]
            mean = comm.all_sum(torch.matmul(km, coeffs[..., None, :, None])[..., 0], group)
            return torch.stack([mean.broadcast_to(var.shape), var], 0)

        out = self._map_query_chunks(one, x, nb)
        pmean, pvar = out[0], out[1]
        if inttask:
            pmean, pvar = pmean[..., 0, :], pvar[..., 0, :]
        return pmean, pvar

    def post_cov(self, x0, x1, task0=None, task1=None, n=None):
        """Posterior covariance, (..., T0, T1, N0, N1); ``n`` projects it to
        future sample counts.  When the two query sets and task lists are
        equal (decided on the host), each (t, t) block's diagonal is clamped
        at 0.

        Two-level tiling: the query budget split in thirds, one for the
        solved block ``K^-1 k(X, x1-block)`` (B1 query rows, reused against
        every x0 chunk), one for the live x0 cross-kernel chunk, one for the
        solves' temporaries."""
        equal_x = x0 is x1
        if not equal_x:
            h0, h1 = (torch.as_tensor(v).cpu().numpy() for v in (x0, x1))
            equal_x = h0.shape == h1.shape and bool(np.array_equal(h0, h1))
        x0, x1 = self._query_points(x0), self._query_points(x1)
        n = self._norm_n(n)
        task0 = self.default_task if task0 is None else task0
        task1 = self.default_task if task1 is None else task1
        task0, inttask0 = _as_task_array(task0, self.num_tasks)
        task1, inttask1 = _as_task_array(task1, self.num_tasks)
        equal = equal_x and np.array_equal(task0, task1)
        self._warm_for_query(n)
        total_n = max(int(self._cols(n).sum()), 1)
        third = self._QUERY_CHUNK_BYTES // 3
        item = torch.empty((), dtype=self.dtype).element_size()
        nb = max(1, third // (self._QUERY_LIVE_FACTOR * total_n * self._query_itemsize()))
        nb0, nb1 = int(min(x0.shape[0], nb)), int(min(x1.shape[0], nb))
        B1 = int(max(nb1, min(x1.shape[0], third // (max(len(task1), 1) * total_n * item))))
        pp = self._query_pre_permuted(n)
        raw = self._raw_dict()
        params = self._transformed(raw)
        kmat_tasks = self._task_gram(raw)
        scale, ls = params["scale"], params["lengthscales"]
        solver = self._query_solver_any(raw, n)  # factorized once
        group = self._seq_group

        def prior_tile(x0c, x1c):
            return torch.stack([torch.stack([
                self._kernel_explicit(x0c[:, None, :], x1c[None, :, :], self.derivatives[t0],
                                      self.derivatives[t1], self.derivatives_coeffs[t0],
                                      self.derivatives_coeffs[t1], scale, ls,
                                      factor=kmat_tasks[..., t0, t1, None, None])
                for t1 in task1], -3) for t0 in task0], -4)

        def solve_rows(x1c):
            # pre-permuted rows in, equally permuted solve out: the einsum below
            # contracts both sides in the same column order
            kmat = self._cross_kmat(x1c, task1, n, params, kmat_tasks)
            return solver.gram_matrix_solve(kmat, extra_ndim=2, pre_permuted=pp)

        def per_block(x1b):      # (B1, d) -> (..., T0, T1, N0, B1)
            t_sol = self._map_query_chunks(solve_rows, x1b, nb1, dim=-2)

            def inner(x0c):      # (nb0, d) -> (..., T0, T1, nb0, B1)
                kmat = self._cross_kmat(x0c, task0, n, params, kmat_tasks)
                # a rank's columns, then one all-reduce a tile under a sequence mesh
                return prior_tile(x0c, x1b) - comm.all_sum(
                    torch.einsum("...ani,...bmi->...abnm", kmat, t_sol), group)
            return self._map_query_chunks(inner, x0, nb0, dim=-2)

        pcov = self._map_query_chunks(per_block, x1, B1, dim=-1)
        if equal:
            for t in range(len(task0)):
                pcov[..., t, t, :, :].diagonal(dim1=-2, dim2=-1).clamp_(min=0.0)
        if inttask0 and inttask1:
            return pcov[..., 0, 0, :, :]
        if inttask0:
            return pcov[..., 0, :, :, :]
        if inttask1:
            return pcov[..., :, 0, :, :]
        return pcov

    def post_error(self, x, task=None, n=None, confidence=0.99):
        """``(pvar, q, q * sqrt(pvar))``: the posterior variance, the normal
        quantile of the two-sided ``confidence`` and the error bound."""
        q = _check_confidence(confidence)
        pvar = self.post_var(x, task=task, n=n)
        return pvar, q, q * torch.sqrt(pvar)

    def post_ci(self, x, task=None, confidence=0.99):
        """Posterior credible interval ``(pmean, pvar, q, lo, hi)`` from one
        fused mean-and-variance pass.  As in the JAX package (and the
        reference's published semantics) the half-width is ``q * perror``
        with ``perror = q * sqrt(pvar)``."""
        q = _check_confidence(confidence)
        pmean, pvar = self.post_mean_var(x, task=task)
        perror = q * torch.sqrt(pvar)
        return pmean, pvar, q, pmean - q * perror, pmean + q * perror

    def post_cubature_error(self, task=None, n=None, confidence=0.99):
        """``(pcvar, q, q * sqrt(pcvar))`` for the integral over [0,1]^d."""
        q = _check_confidence(confidence)
        pcvar = self.post_cubature_var(task=task, n=n)
        return pcvar, q, q * torch.sqrt(pcvar)

    def post_cubature_ci(self, task=None, confidence=0.99):
        """Cubature credible interval ``(pcmean, pcvar, q, lo, hi)``, of
        half-width ``q * sqrt(pcvar)``."""
        pcvar, q, pcerror = self.post_cubature_error(task=task, confidence=confidence)
        pcmean = self.post_cubature_mean(task=task)
        return pcmean, pcvar, q, pcmean - pcerror, pcmean + pcerror

    # ------------------------------------------------------------------
    # fitting
    # ------------------------------------------------------------------
    def fit(self,
            loss_metric: str = "MLL",
            iterations: int = 5000,
            lr: float = None,
            stop_crit_improvement_threshold: float = 5e-2,
            stop_crit_wait_iterations: int = 10,
            store_hists: bool = False,
            store_loss_hist: bool = False,
            store_scale_hist: bool = False,
            store_lengthscales_hist: bool = False,
            store_noise_hist: bool = False,
            store_task_kernel_hist: bool = False,
            verbose: int = 5,
            verbose_indent: int = 4,
            masks=None,
            cv_weights=1,
            checkpoint_path: str = None,
            checkpoint_every: int = 50,
            resume_from: str = None,
            steps_per_dispatch: int = None):
        """Hyperparameter optimization by Rprop with early stopping, as in the
        JAX package: loss metrics MLL / GCV / CV, the best parameters
        restored at the end, early stopping once the loss has not improved
        by ``stop_crit_improvement_threshold`` (relative) for
        ``stop_crit_wait_iterations`` iterations, optional histories.

        ``steps_per_dispatch`` K: steps run back to back with their losses
        kept on the device and fetched once per K steps (default 1 on the
        CPU, 32 on the card).  Every step's record is kept, so early
        stopping, histories, verbose lines and checkpoints are those of
        K = 1; at most K - 1 steps past the stop are computed and dropped.

        K = -1 is the JAX package's fused fit: the whole fit in blocks of
        at most ``FUSED_BLOCK`` = 64 steps, one host fetch a block.  It runs
        the loop above at K = 64, whose one fetch a block carries the
        block's losses; early stopping and the best-parameter restore follow
        from them on the host, and the steps past the stop are dropped where
        the JAX package computes them as masked no-ops.  So the result is the
        JAX package's -1 and K = 1's (bit for bit in float64).  Two
        deliberate deviations: a block runs ``min(64, iterations + 1 - i)``
        steps, so no step past the iteration cap is computed (a 20-iteration
        fit computes 21 steps, not 64); and -1 is not the default on the
        card, where the JAX package makes it the default when nothing
        per-step is asked for: eager PyTorch has no relay backend's
        per-fetch cost to amortize.  As in the JAX package, K = -1 raises
        ``ValueError`` with histories, a verbose line (``verbose`` > 0) or
        ``checkpoint_path``; ``resume_from`` continues as with any K.

        ``masks``: index arrays (one row per batch dim, or a boolean mask)
        selecting the members of a ``shape_batch`` fleet whose losses are
        summed; the others' parameters then get no gradient.

        ``checkpoint_path`` / ``checkpoint_every``: the whole optimization
        state (raw parameters, Rprop step sizes and previous gradients, the
        best parameters and loss, the early-stopping counters, the iteration
        and the histories) is written to an ``.npz`` with the JAX package's
        keys every ``checkpoint_every`` iterations and at the stop;
        ``resume_from`` continues from one on the same trajectory as an
        uninterrupted run.

        Returns ``{"iterations": i, "<name>_hist": array, ...}``.
        """
        loss_metric = loss_metric.upper()
        if loss_metric not in ("MLL", "GCV", "CV"):
            raise ValueError(f"loss_metric must be MLL, GCV or CV, got {loss_metric}")
        if not (self.n > 0).any():
            raise ValueError("cannot fit without data")
        if not (isinstance(iterations, int) and iterations >= 0):
            raise ValueError("iterations must be a non-negative int")
        if steps_per_dispatch is None:
            steps_per_dispatch = 1 if self.device.type == "cpu" else 32
        K = int(steps_per_dispatch)
        lr = 1e-1 if lr is None else lr
        logtol = math.log(1 + stop_crit_improvement_threshold)
        trainable = {k: p.trainable for k, p in self.params.items()}
        store = {"loss": store_hists or store_loss_hist}
        for name, flag, keys in (
                ("scale", store_scale_hist, ("scale",)),
                ("lengthscales", store_lengthscales_hist, ("lengthscales",)),
                ("noise", store_noise_hist, ("noise",)),
                ("task_kernel", store_task_kernel_hist,
                 ("factor_task_kernel", "noise_task_kernel"))):
            store[name] = store_hists or (flag and any(trainable[k] for k in keys))
        hists = {f"{k}_hist": [] for k, on in store.items() if on}
        if K == -1:
            if hists or verbose or checkpoint_path is not None:
                raise ValueError("steps_per_dispatch=-1 (fused fit) cannot produce per-step "
                                 "histories, verbose output or checkpoints")
            K = FUSED_BLOCK
        K = max(1, K)
        if masks is not None:
            masks = np.atleast_2d(np.asarray(masks))
            d_out = (int(np.prod(np.empty(self.shape_batch)[(*masks,)].shape))
                     if self.shape_batch else 1)
        else:
            d_out = int(np.prod(self.shape_batch)) if self.shape_batch else 1
        if verbose:
            head = "%16s | %-10s | %-10s | %-10s" % ("iter of %.1e" % iterations, "loss",
                                                     "term1", "term2")
            print(" " * verbose_indent + head)
            print(" " * verbose_indent + "~" * len(head))
        mll_const = d_out * float(self.n.sum()) * math.log(2 * math.pi)
        loss_and_grad = self._make_loss_fn(loss_metric, masks, d_out, mll_const, cv_weights)
        fit_data = self._fit_data()
        raw = self._raw_dict()
        opt_state = rprop_init(raw, lr=lr)
        best_loss = save_loss = math.inf
        best_raw = raw
        waits = i0 = 0
        if resume_from is not None:
            with np.load(resume_from) as ck:
                def dev(a, like):
                    return torch.as_tensor(a, dtype=like.dtype, device=like.device)
                best_raw = {k: dev(ck[f"best_{k}"], v) for k, v in raw.items()}
                opt_state = opt_state._replace(
                    step_sizes={k: dev(ck[f"ss_{k}"], v) for k, v in raw.items()},
                    prev_grad={k: dev(ck[f"pg_{k}"], v) for k, v in raw.items()})
                raw = {k: dev(ck[f"raw_{k}"], v) for k, v in raw.items()}
                best_loss, save_loss = float(ck["best_loss"]), float(ck["save_loss"])
                waits, i0 = int(ck["waits"]), int(ck["iteration"]) + 1
                for k in hists:
                    if f"hist_{k}" in ck.files:
                        h = ck[f"hist_{k}"]
                        hists[k] = [float(v) for v in h] if k == "loss_hist" else list(h)

        def host(t):
            return t.detach().cpu().numpy()

        def save_checkpoint(raw_ck, opt_ck, iteration):
            arrays = {"best_loss": best_loss, "save_loss": save_loss, "waits": waits,
                      "iteration": iteration}
            for k in raw_ck:
                arrays[f"raw_{k}"] = host(raw_ck[k])
                arrays[f"best_{k}"] = host(best_raw[k])
                arrays[f"ss_{k}"] = host(opt_ck.step_sizes[k])
                arrays[f"pg_{k}"] = host(opt_ck.prev_grad[k])
            for k, v in hists.items():
                arrays[f"hist_{k}"] = np.asarray(v) if v else np.zeros((0,))
            np.savez(checkpoint_path, **arrays)

        def bookkeep(it, loss_f, term1, term2, raw_pre):
            """One iteration's host logic; True when the fit stops here."""
            nonlocal best_loss, best_raw, save_loss, waits
            if loss_f < best_loss:
                best_loss, best_raw = loss_f, raw_pre
            if (save_loss - loss_f) > logtol:
                waits, save_loss = 0, best_loss
            else:
                waits += 1
            stop = it == iterations or waits == stop_crit_wait_iterations
            if store["loss"]:
                hists["loss_hist"].append(-loss_f if loss_metric == "MLL" else loss_f)
            for k in ("scale", "lengthscales", "noise"):
                if store[k]:
                    hists[f"{k}_hist"].append(host(self.params[k].from_raw(raw_pre[k])))
            if store["task_kernel"]:
                hists["task_kernel_hist"].append(host(self._task_gram(raw_pre)))
            if verbose and (it % verbose == 0 or stop):
                print(" " * verbose_indent + "%16.2e | %-10.2e | %-10.2e | %-10.2e"
                      % (it, loss_f, term1, term2))
            return stop

        i, stopped = i0, False
        while i <= iterations and not stopped:
            k_eff = min(K, iterations + 1 - i)
            steps, stats = self._fit_steps(loss_and_grad, raw, opt_state, fit_data,
                                           trainable, k_eff)
            for j, (raw_pre, raw_post, opt_post) in enumerate(steps):
                it = i + j
                if bookkeep(it, *stats[j], raw_pre):
                    stopped, i = True, it
                    if checkpoint_path is not None:
                        save_checkpoint(raw_post, opt_post, it)
                    break
                if checkpoint_path is not None and (it + 1) % checkpoint_every == 0:
                    save_checkpoint(raw_post, opt_post, it)
            if not stopped:
                _, raw, opt_state = steps[-1]
                i += k_eff
        self._set_raw(best_raw)
        data = {"iterations": i}
        for k, v in hists.items():
            data[k] = np.stack(v) if len(v) else np.asarray(v)
        return data

    @staticmethod
    def _fit_steps(loss_and_grad, raw, opt_state, data, trainable, k: int):
        """``k`` fit steps back to back.  Returns the steps' ``(raw before,
        raw after, Rprop state after)`` and their ``(loss, term1, term2)``
        as host floats, fetched from the device once."""
        steps, stats = [], []
        for _ in range(k):
            loss, terms, grads = loss_and_grad(raw, data)
            with torch.no_grad():
                raw_n, opt_n = rprop_update(grads, opt_state, raw, trainable)
            stats.append(torch.stack([loss, *terms]))
            steps.append((raw, raw_n, opt_n))
            raw, opt_state = raw_n, opt_n
        return steps, torch.stack(stats).tolist()

    def _fit_data(self):
        """Tensors handed to the loss besides the parameters (None: none)."""
        return None

    def _solver_pure(self, raw, data=None):
        """Solver handle built from explicit raw parameters (differentiable)."""
        raise NotImplementedError

    def _make_loss_fn(self, metric, masks, d_out, mll_const, cv_weights):
        """``loss_and_grad(raw, data) -> (loss, (term1, term2), grads)`` of
        the chosen loss over the raw parameters: the loss and its terms as
        0-d tensors (the terms NaN where the metric has none), ``grads`` one
        tensor per parameter, zero for those that are not trained.

        Under a sequence mesh every rank computes the same global loss (the
        solver's sums over n are differentiable all-reduces, whose backward
        sums the ranks' gradients): each rank seeds the backward with 1 / D
        and the gradients, all of replicated parameters, are then summed
        over the group.  A per-point ``cv_weights`` is cut to the rank's
        block of each task's points, like the ytildes."""
        trainable = {k: p.trainable for k, p in self.params.items()}
        group = self._seq_group
        cv_w = torch.as_tensor(np.asarray(cv_weights, dtype=np.float64), dtype=self.dtype,
                               device=self.device)
        if group is not None and cv_w.ndim and cv_w.shape[-1] == int(self.n.sum()) > 1:
            offs = np.concatenate([[0], np.cumsum(self.n)])
            cv_w = _cat([cv_w[..., offs[l]:offs[l + 1]][..., self._seq_block(int(self.n[l]))]
                         for l in range(self.num_tasks)], -1)
        # the fleet members a masked loss sums over: (..., *masks, last axis)
        sel = None if masks is None else tuple(
            torch.as_tensor(np.asarray(m), device=self.device) for m in masks)
        full = self.shape_batch + (1,)

        def pick(t, last):
            return t[(Ellipsis, *sel, last)]

        def loss_terms(raw, data):
            solver = self._solver_pure(raw, data)
            if metric == "MLL":
                norm_term, logdet = solver.norm_logdet_terms()
                if sel is None:
                    term1 = norm_term.sum()
                    term2 = d_out / float(np.prod(logdet.shape)) * logdet.sum()
                else:
                    term1 = pick(norm_term, 0).sum()
                    term2 = pick(logdet.expand(full), 0).sum()
                return 0.5 * (term1 + term2 + mll_const), term1, term2
            if metric == "GCV":
                numer, denom = solver.gcv_terms()
                if sel is None:
                    loss = (numer / denom).sum()
                else:
                    loss = (pick(numer, slice(None)) / pick(denom.expand(full),
                                                            slice(None))).sum()
                return loss, numer.sum(), denom.sum()
            coeffs, inv_diag = solver.coeffs(), solver.inv_diag()
            squared = comm.all_sum(((coeffs / inv_diag) ** 2 * cv_w).sum(-1, keepdim=True),
                                   group)
            loss = squared.sum() if sel is None else pick(squared, 0).sum()
            nan = torch.full((), math.nan, dtype=loss.dtype, device=loss.device)
            return loss, nan, nan

        def loss_and_grad(raw, data):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(trainable[k]) for k, v in raw.items()}
                loss, term1, term2 = loss_terms(leaves, data)
                keys = [k for k in leaves if trainable[k]]
                seed = torch.full_like(loss, 1.0 / comm.size(group))
                gs = (torch.autograd.grad(loss, [leaves[k] for k in keys], grad_outputs=seed,
                                          allow_unused=True) if keys else ())
            grads = {k: torch.zeros_like(v) for k, v in raw.items()}
            for k, g in zip(keys, gs):
                if g is not None:
                    grads[k] = comm.sum_(g, group)
            return loss.detach(), (term1.detach(), term2.detach()), grads

        return loss_and_grad
