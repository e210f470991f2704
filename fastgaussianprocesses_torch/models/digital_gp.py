"""Fast Gaussian process regression with base-2 digital nets (Sobol') and
digitally-shift-invariant (weighted-Walsh series) kernels (counterpart of
``fastgaussianprocesses_tpu/models/digital_gp.py``).

O(n log n) fits and posterior queries via the orthonormal fast Walsh-Hadamard
transform: on the CUDA card through kernel K4 (``ops/fwht``), on the CPU
through its plain version.  The general solver ``models/fast._FastSolver``
serves it.
"""

import numpy as np
import torch

from ..kernels import series
from ..ops import transforms as tr
from ..ops.bitops import log2_int
from ..ops.walsh_closed import MAX_ALPHA
from ..points.digital_net import DigitalNetB2
from ..parallel import mesh as pm
from .fast import AbstractFastGP


class FastGPDigitalNetB2(AbstractFastGP):
    r"""DSI-kernel GP on digitally-shifted Sobol' nets.

    Args:
        seqs: a DigitalNetB2, a list of them (one per task), or an int
            dimension (sequences are then created with per-task seeds spawned
            from ``seed_for_seq``, as the JAX package does).
        num_tasks, seed_for_seq, alpha, scale, lengthscales, noise, ...:
            see AbstractGP; the default noise is 1e-16, as in the JAX package.
        dtype: compute dtype (float32 on CUDA, float64 on the CPU by default).
        device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Example (CPU, float64)::

        gp = FastGPDigitalNetB2(2, seed_for_seq=7, alpha=2, device="cpu")
        x = gp.get_x_next(64)
        gp.add_y_next(torch.sin(2 * torch.pi * x[:, 0]) + x.sum(1))
        pm, pv = gp.post_mean_var(torch.rand(3, 2, dtype=torch.float64))
    """

    def __init__(self, seqs, num_tasks=None, seed_for_seq=None, alpha=2,
                 noise=1e-16, **kwargs):
        nt = 1 if num_tasks is None else num_tasks
        if isinstance(seqs, int):
            seeds = np.random.SeedSequence(seed_for_seq).spawn(nt)
            seqs = [DigitalNetB2(seqs, seed=s, randomize="DS") for s in seeds]
        if isinstance(seqs, DigitalNetB2):
            seqs = [seqs]
        if not all(isinstance(s, DigitalNetB2) and s.order == "NATURAL" for s in seqs):
            raise ValueError("seqs must be natural-order DigitalNetB2 generators")
        # cross-task diagonalization needs a shared base net: only digital
        # shifts may differ between tasks
        allowed = ("FALSE", "DS", "LMS", "LMS_DS") if nt == 1 else ("FALSE", "DS")
        if not all(s.randomize in allowed for s in seqs):
            raise ValueError(f"randomize must be one of {allowed}")
        if len({s.t for s in seqs}) != 1:
            raise ValueError("all sequences must share the same t")
        self.t = seqs[0].t
        a = np.asarray(alpha)
        if not ((1 <= a) & (a <= MAX_ALPHA)).all():
            raise ValueError(f"alpha must be in [1, {MAX_ALPHA}]")
        super().__init__(alpha, seqs, num_tasks=num_tasks, noise=noise, **kwargs)
        if self._has_derivatives and any((dv > 0).any() for dv in self.derivatives):
            if not (self.alpha >= 2).all():
                raise ValueError("derivatives require alpha >= 2")

    def _ftout_dtype(self):
        return self.dtype

    def _ft(self, x):
        if self._seq_mesh is not None:
            # K4 on the rank's block subtracts the global row means as it loads
            return tr._centre_on_load(
                lambda v, m: pm.sharded_fwht(v, self._seq_mesh, self._seq_axis, m), x,
                self._seq_group)
        return tr.ft_stable_fwht(x)

    _ift = _ft  # the FWHT is its own inverse

    def get_omega(self, m):
        return 1.0

    _char_kind = "walsh"

    def _point_class(self, task, n_l, r_l):
        """Class of point i for exact inverse diagonals: its top log2(r_l) bits."""
        return np.arange(n_l) >> (log2_int(n_l) - log2_int(r_l))

    @property
    def _xb_int_dtype(self):
        # int32 halves the integer traffic of kernel evaluations and is exact
        # for t <= 30 bits
        return np.int32 if self.t <= 30 else np.int64

    def _sample(self, seq, n_min, n_max):
        xb = seq(n_min, n_max, return_binary=True).astype(self._xb_int_dtype)
        return xb * 2.0 ** -self.t, xb

    def _convert_to_b(self, x):
        """t-bit fixed-point form of float points."""
        out_dtype = torch.int32 if self.t <= 30 else torch.int64
        return torch.floor((x % 1.0) * (2 ** self.t)).to(out_dtype)

    def _as_b(self, a):
        return self._convert_to_b(a) if a.is_floating_point() else a

    def _ominus(self, a, b):
        return series.digital_ominus(self._as_b(a), self._as_b(b))

    def _parts_from_delta(self, delta, beta, kappa):
        return series.dsi_parts_from_delta(delta, self.t, self.alpha, beta, kappa,
                                           dtype=self.dtype)

    def _part_dim(self, delta_j, j, b, k):
        return series.dsi_part_dim(delta_j, self.t, int(self.alpha[j]), b, k, dtype=self.dtype)

    def _part_dim_pair(self, xj, zj, j, b, k):
        """Side-wise series term: the bit-spread features are computed once
        per side (they commute with the XOR group op), so the O(N n) work of
        a cross-kernel query is one XOR and convert per chunk plus the
        polynomial."""
        return series.dsi_part_pair(self._as_b(xj), self._as_b(zj), self.t,
                                    int(self.alpha[j]), b, k, dtype=self.dtype)
