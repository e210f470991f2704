"""Standard (dense, O(n^3)) Gaussian process regression (counterpart of
``fastgaussianprocesses_tpu/models/standard_gp.py``).

A general-purpose GP on arbitrary points or user data, and the semantic
oracle of the fast models.  The Cholesky factor and the triangular solves
are library calls (``torch.linalg``), as in the JAX package, which computes
them outside any Pallas kernel.
"""

import numpy as np
import torch

from ..kernels.dense import KERNEL_CLASSES, dense_kernel
from ..kernels.series import times_factor
from ..points.digital_net import DigitalNetB2
from .abstract import AbstractGP, _as_task_array

# the nugget factor is doubled at most this many times before a Cholesky
# that still fails is returned NaN-filled, as the JAX package's bounded scan
SPD_RETRIES = 16


class _DataSeq:
    """Wraps user-provided points as a sequence: refuses to generate beyond
    the provided n."""

    order = "NATURAL"
    replications = 1

    def __init__(self, x):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError("data x needs shape (n, d)")
        self.x = x
        self.n, self.d = x.shape

    def __call__(self, n_min, n_max):
        if n_max > self.n:
            raise ValueError("cannot generate beyond the provided data")
        return self.x[n_min:n_max]


def _trace(a):
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


class _StandardSolver:
    """Dense multitask Cholesky solver with the JAX package's nugget
    escalation: the nugget factor doubles, at most ``SPD_RETRIES`` times,
    while the factor has failed.  ``torch.linalg.cholesky_ex`` flags a
    failed factor by ``info != 0`` (and may leave finite garbage), so a
    factor counts as failed where ``info != 0`` or it has a non-finite
    entry; one that still fails at the cap is NaN-filled, as JAX's
    Cholesky returns it.

    The failure test reduces over every axis of the Gram batch but the
    leading axes that ``raw`` has beyond the model's own parameter shapes
    (the chains of ``fit/hmc``): one factor for the model, as in the JAX
    package, and one a chain, as its ``vmap`` over chains gives.
    """

    def __init__(self, model, raw, n):
        self.model = model
        self.n = np.asarray(n, dtype=np.int64)
        params = model._transformed(raw)
        kmat_tasks = model._task_gram(raw)
        scale, ls = params["scale"], params["lengthscales"]
        noise = params["noise"]
        T = model.num_tasks
        lower = {}
        for l0 in range(T):
            for l1 in range(l0 + 1):
                x0 = model.get_x(l0, n=int(self.n[l0]))
                x1 = model.get_x(l1, n=int(self.n[l1]))
                lower[(l0, l1)] = model._kernel_explicit(
                    x0[:, None, :], x1[None, :, :],
                    model.derivatives[l0], model.derivatives[l1],
                    model.derivatives_coeffs[l0], model.derivatives_coeffs[l1],
                    scale, ls)
        if model.adaptive_nugget:
            tr00 = _trace(lower[(0, 0)])
            nus = [noise[..., 0] * _trace(lower[(l, l)]) / tr00 for l in range(T)]
        else:
            nus = [noise[..., 0]] * T
        # rounding-level relative nugget floor (the JAX package's): the max
        # eigenvalue is bounded by the trace, so 64 eps trace caps the
        # condition number at ~1/(64 eps) while staying statistically
        # invisible in float64
        eps = float(torch.finfo(model.dtype).eps)
        nus = [torch.maximum(nu, 64.0 * eps * _trace(lower[(l, l)])) for l, nu in enumerate(nus)]

        def assemble(spd_factor):
            rows = []
            for l0 in range(T):
                cols = []
                for l1 in range(T):
                    kv = lower[(l0, l1)] if l1 <= l0 else lower[(l1, l0)].transpose(-1, -2)
                    if l0 == l1:
                        eye = torch.eye(int(self.n[l0]), dtype=kv.dtype, device=kv.device)
                        kv = kv + (spd_factor * nus[l0])[..., None, None] * eye
                    cols.append(kmat_tasks[..., l0, l1, None, None] * kv)
                rows.append(torch.cat(cols, -1))
            return torch.cat(rows, -2)

        chain_ndim = max(v.ndim - model.params[k].raw.ndim for k, v in raw.items())
        spd = torch.ones((), dtype=model.dtype, device=model.device)
        chol, failed = self._factor(assemble(spd), chain_ndim)
        for _ in range(SPD_RETRIES):
            if not bool(failed.any()):
                break
            spd = torch.where(failed, 2.0 * spd, spd)
            chol_r, failed_r = self._factor(assemble(spd), chain_ndim)
            # groups that had succeeded keep their factor
            chol = torch.where(failed[..., None, None], chol_r, chol)
            failed = failed & failed_r
        if bool(failed.any()):
            chol = torch.where(failed[..., None, None], torch.full_like(chol, float("nan")), chol)
        lead = failed.shape[:min(chain_ndim, failed.ndim)]
        self.spd_factor = spd.expand(failed.shape).reshape(lead)
        self.chol = chol
        self.logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        ntot = int(self.n.sum())
        eye = torch.eye(ntot, dtype=chol.dtype, device=chol.device)
        linv = torch.linalg.solve_triangular(chol, eye.expand(chol.shape), upper=False)
        self.thetainv = linv.transpose(-1, -2) @ linv
        self.kmat_tasks = kmat_tasks
        self.scale, self.lengthscales = scale, ls
        self.noise = noise

    @staticmethod
    def _factor(gram, chain_ndim):
        """``(chol, failed)``: the factor and whether it failed, reduced over
        every batch axis but the leading ``chain_ndim`` (kept as size 1)."""
        chol, info = torch.linalg.cholesky_ex(gram)
        bad = (info != 0) | ~torch.isfinite(chol).all(-1).all(-1)
        lead = min(chain_ndim, bad.ndim)
        failed = bad.reshape(bad.shape[:lead] + (-1,)).any(-1)
        return chol, failed.reshape(bad.shape[:lead] + (1,) * (bad.ndim - lead))

    def gram_matrix_solve(self, ycat, extra_ndim=0, pre_permuted=False):
        if pre_permuted:
            raise ValueError("the dense solver has no query column order")
        inv = self.thetainv
        if extra_ndim:
            inv = inv.reshape(inv.shape[:-2] + (1,) * extra_ndim + inv.shape[-2:])
        return torch.einsum("...ij,...j->...i", inv, ycat)

    def gram_quad_diag(self, ycat, extra_ndim=0, pre_permuted=False):
        """Diagonal of ``Y K^-1 Y^T`` (solve, then contract)."""
        return (self.gram_matrix_solve(ycat, extra_ndim=extra_ndim) * ycat).sum(-1)

    def _ycat(self):
        m = self.model
        return torch.cat([m._y[l].expand(m.shape_batch + (m._y[l].shape[-1],))
                          for l in range(m.num_tasks)], -1)

    def norm_logdet_terms(self):
        y = self._ycat()
        v = self.gram_matrix_solve(y)
        return (y * v).sum(-1, keepdim=True), self.logdet[..., None]

    def gcv_terms(self):
        y = self._ycat()
        v = self.gram_matrix_solve(y)
        numer = (v**2).sum(-1, keepdim=True)
        tr = _trace(self.thetainv)
        denom = ((tr / self.thetainv.shape[-1]) ** 2)[..., None]
        return numer, denom

    def coeffs(self):
        return self.gram_matrix_solve(self._ycat())

    def inv_diag(self):
        return torch.diagonal(self.thetainv, dim1=-2, dim2=-1)


class StandardGP(AbstractGP):
    """Dense GP with Gaussian/Matern kernels on arbitrary point generators
    or user data.

    Args beyond AbstractGP:
        seqs: generator(s), an int dimension (Sobol' nets with seeds spawned
            from ``seed_for_seq``, digitally shifted), or, with
            ``data={'x': ..., 'y': ...}``, the dimension.
        kernel_class: 'gaussian' | 'matern12' | 'matern32' | 'matern52'.
        data: fixed observations ingested at construction (one array a task,
            or a list of them).

    Example (CPU, float64; the values of the JAX package's doctest)::

        gp = StandardGP(2, seed_for_seq=7, device="cpu")
        x = gp.get_x_next(64)
        gp.add_y_next(torch.sin(2 * torch.pi * x[:, 0]) * torch.cos(2 * torch.pi * x[:, 1])
                      + x.sum(1))
        gp.fit(iterations=40, verbose=0)
        pm, pv = gp.post_mean_var(torch.tensor([[0.1, 0.2], [0.5, 0.5], [0.9, 0.8]]))
        # pm ~ [0.4832, 0.9991, 1.5233]; gp.post_cubature_mean() ~ 1.0002
    """

    def __init__(self, seqs, num_tasks=None, seed_for_seq=None,
                 noise=1e-4, kernel_class="Gaussian", adaptive_nugget=True,
                 data=None, **kwargs):
        nt = 1 if num_tasks is None else num_tasks
        if data is not None:
            if not isinstance(seqs, int):
                raise ValueError("data= requires seqs to be the dimension")
            xs, ys = data["x"], data["y"]
            if not isinstance(xs, (list, tuple)):
                xs = [xs]
            if not isinstance(ys, (list, tuple)):
                ys = [ys]
            if len(xs) != nt or len(ys) != nt:
                raise ValueError(f"data needs {nt} x and y arrays")
            seqs = [_DataSeq(torch.as_tensor(x).cpu().numpy()) for x in xs]
        else:
            if isinstance(seqs, int):
                seeds = np.random.SeedSequence(seed_for_seq).spawn(nt)
                seqs = [DigitalNetB2(seqs, seed=s, randomize="DS") for s in seeds]
            if not isinstance(seqs, (list, tuple)):
                seqs = [seqs]
        kernel_class = kernel_class.lower()
        if kernel_class not in KERNEL_CLASSES:
            raise ValueError(f"kernel_class must be in {KERNEL_CLASSES}")
        self.kernel_class = kernel_class
        super().__init__(seqs, num_tasks=num_tasks, noise=noise,
                         adaptive_nugget=adaptive_nugget, **kwargs)
        self._solver_cache = {}
        if data is not None:
            self.add_y_next(list(ys), task=list(range(nt)))

    # -- kernel ----------------------------------------------------------
    def _kernel_explicit(self, x0, x1, beta0, beta1, c0, c1, scale, lengthscales, factor=None):
        return times_factor(dense_kernel(self.kernel_class, x0, x1, beta0, beta1, c0, c1,
                                         scale, lengthscales), factor)

    # -- solver ----------------------------------------------------------
    def _solver(self, n=None):
        n = self._norm_n(n) if n is not None else self.n.copy()
        key = (self._version, tuple(int(v) for v in n))
        if key not in self._solver_cache:
            for l in range(self.num_tasks):
                self._get_xxb(l, int(n[l]))
            self._solver_cache[key] = _StandardSolver(self, self._raw_dict(), n)
            if len(self._solver_cache) > 8:
                self._solver_cache.pop(next(iter(self._solver_cache)))
        return self._solver_cache[key]

    def _warm_for_fit(self):
        for l in range(self.num_tasks):
            self._get_xxb(l, int(self.n[l]))

    def _solver_pure(self, raw, data=None):
        return _StandardSolver(self, raw, self.n)

    def _query_solver_any(self, raw, n):
        return _StandardSolver(self, raw, np.asarray(n, dtype=np.int64))

    def _on_data_change(self):
        self._solver_cache.clear()

    # -- Gaussian-kernel cubature ----------------------------------------
    def _kint(self, n, task_sel):
        """Integrated cross-covariances ``sum_l S[task, l] k_int_l``, (..., T, sum n)."""
        if self.kernel_class != "gaussian":
            raise ValueError("closed-form cubature is available for the Gaussian kernel only")
        kmat_tasks = self.gram_matrix_tasks
        scale, ls = self.scale, self.lengthscales
        tsel = torch.as_tensor(task_sel, device=self.device)
        pieces = []
        for l in range(self.num_tasks):
            x = self.get_x(l, n=int(n[l]))  # (n_l, d)
            lsb = ls[..., None, :]
            sig = torch.sqrt(lsb)
            cdf_diff = torch.special.ndtr((1.0 - x) / sig) - torch.special.ndtr((0.0 - x) / sig)
            part = scale * (torch.sqrt(2 * torch.pi * lsb) * cdf_diff).prod(-1)  # (..., n_l)
            pieces.append(kmat_tasks[..., tsel, l, None] * part[..., None, :])
        return torch.cat(pieces, -1)

    def post_cubature_mean(self, task=None):
        """Posterior mean of the integral over [0,1]^d (Normal-CDF integrals)."""
        coeffs = self.coeffs
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        kints = self._kint(self.n, task)
        pcmean = (kints * coeffs[..., None, :]).sum(-1)
        return pcmean[..., 0] if inttask else pcmean

    def _tprod(self):
        ls = self.lengthscales + torch.zeros(self.d, dtype=self.dtype, device=self.device)
        t = 2 * (-1 + torch.exp(-1 / (2 * ls))) * ls + torch.sqrt(2 * torch.pi * ls) * torch.erf(
            1 / torch.sqrt(2 * ls))
        return t.prod(-1)

    def post_cubature_var(self, task=None, n=None):
        """Posterior variance of the integral; ``n`` projects it to future
        sample counts."""
        n = self._norm_n(n)
        solver = self._solver(n)
        kmat_tasks = self.gram_matrix_tasks
        if task is None:
            task = self.default_task
        task, inttask = _as_task_array(task, self.num_tasks)
        kints = self._kint(n, task)
        v = solver.gram_matrix_solve(kints, extra_ndim=1)
        tsel = torch.as_tensor(task, device=self.device)
        tval = self.scale * kmat_tasks[..., tsel, tsel] * self._tprod()[..., None]
        pcvar = torch.clamp(tval - (kints * v).sum(-1), min=0.0)
        return pcvar[..., 0] if inttask else pcvar

    def post_cubature_cov(self, task0=None, task1=None, n=None):
        """Posterior covariance of the integral between tasks, (..., T0, T1);
        its diagonal clamped at 0 when the two task lists are equal."""
        n = self._norm_n(n)
        solver = self._solver(n)
        kmat_tasks = self.gram_matrix_tasks
        task0 = self.default_task if task0 is None else task0
        task1 = self.default_task if task1 is None else task1
        task0, inttask0 = _as_task_array(task0, self.num_tasks)
        task1, inttask1 = _as_task_array(task1, self.num_tasks)
        kints0 = self._kint(n, task0)
        kints1 = self._kint(n, task1)
        v = solver.gram_matrix_solve(kints1, extra_ndim=1)
        t0 = torch.as_tensor(task0, device=self.device)
        t1 = torch.as_tensor(task1, device=self.device)
        tval = self.scale[..., None] * kmat_tasks[..., t0, :][..., :, t1] * \
            self._tprod()[..., None, None]
        pccov = tval - torch.einsum("...ai,...bi->...ab", kints0, v)
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
