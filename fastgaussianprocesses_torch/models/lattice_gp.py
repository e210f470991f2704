"""Fast Gaussian process regression with rank-1 lattice points and
shift-invariant (Bernoulli-polynomial series) kernels (counterpart of
``fastgaussianprocesses_tpu/models/lattice_gp.py``).

O(n log n) fits and posterior queries via the orthonormal bit-reversed FFT:
on the CUDA card in float32 through the permuted-spectrum kernels K1-K3
(``ops/perm_fft``), elsewhere through ``torch.fft`` on the half spectrum
(the full spectrum at n = 1).
"""

import numpy as np
import torch

from ..kernels import series
from ..ops import transforms as tr
from ..ops.bernoulli import MAX_ORDER
from ..ops.bitops import bit_reverse_permutation, log2_int
from ..points.lattice import LatticeSeq
from ..parallel import mesh as pm
from .fast import AbstractFastGP


class FastGPLattice(AbstractFastGP):
    r"""Shift-invariant-kernel GP on randomly-shifted rank-1 lattices.

    Args:
        seqs: a LatticeSeq, a list of LatticeSeq (one per task), or an int
            dimension (sequences are then created with per-task seeds
            spawned from ``seed_for_seq``, as the JAX package does).
        num_tasks, seed_for_seq, alpha, scale, lengthscales, noise, ...:
            see AbstractGP.
        dtype: compute dtype (float32 on CUDA, float64 on the CPU by default).
        device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Example (CPU, float64)::

        gp = FastGPLattice(2, seed_for_seq=7, alpha=2, device="cpu")
        x = gp.get_x_next(64)
        gp.add_y_next(torch.sin(2 * torch.pi * x[:, 0]) + x.sum(1))
        pm, pv = gp.post_mean_var(torch.rand(3, 2, dtype=torch.float64))
    """

    def __init__(self, seqs, num_tasks=None, seed_for_seq=None, alpha=2,
                 noise=1e-8, **kwargs):
        nt = 1 if num_tasks is None else num_tasks
        if isinstance(seqs, int):
            seeds = np.random.SeedSequence(seed_for_seq).spawn(nt)
            seqs = [LatticeSeq(seqs, seed=s, randomize="SHIFT") for s in seeds]
        if isinstance(seqs, LatticeSeq):
            seqs = [seqs]
        if not all(isinstance(s, LatticeSeq) and s.order == "NATURAL"
                   and s.randomize in ("FALSE", "SHIFT") for s in seqs):
            raise ValueError("seqs must be natural-order LatticeSeq generators")
        a = np.asarray(alpha)
        if not ((1 <= a) & (2 * a <= MAX_ORDER)).all():
            raise ValueError("alpha must be in [1, 4]")
        super().__init__(alpha, seqs, num_tasks=num_tasks, noise=noise, **kwargs)

    def _ftout_dtype(self):
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def _ft(self, x):
        if self._seq_mesh is not None:
            return tr._stabilize(lambda v: pm.sharded_fftbr(v, self._seq_mesh, self._seq_axis),
                                 x, self._seq_group)
        return tr.ft_stable_lattice(x)

    def _ift(self, x):
        if self._seq_mesh is not None:
            return tr._stabilize(lambda v: pm.sharded_ifftbr(v, self._seq_mesh, self._seq_axis),
                                 x, self._seq_group)
        return tr.ift_stable_lattice(x)

    def _ft_lam(self, k1):
        """The first column's parts are cached bit-reversed: a plain FFT.
        Under a sequence mesh they stay in natural order, and the sharded
        bit-reversed FFT folds the reversal into its index maps."""
        if self._seq_mesh is not None:
            return self._ft(k1)
        return tr.ft_stable_plain_fft(k1)

    def get_omega(self, m):
        return tr.get_omega_lattice(m, dtype=self._ftout_dtype()).to(self.device)

    _char_kind = "fourier"

    def _point_class(self, task, n_l, r_l):
        """Class of point i for exact inverse diagonals: rho_m(i) mod r_l."""
        return bit_reverse_permutation(log2_int(n_l))[:n_l] % r_l

    def _ominus(self, a, b):
        return series.lattice_ominus(a, b)

    def _parts_from_delta(self, delta, beta, kappa):
        return series.si_parts_from_delta(delta, self.alpha, beta, kappa)

    def _part_dim(self, delta_j, j, b, k):
        return series.si_part_dim(delta_j, int(self.alpha[j]), b, k)

    _bernoulli_series = True

    def _get_k1parts_lam(self, l0, l1, n):
        """Bit-reverse-permuted first-column parts in the (p0, p1, d, n) layout,
        so the solver's transform of the first column needs no gather (under
        a sequence mesh: the rank's block in natural order)."""
        if self._seq_mesh is not None:
            return super()._get_k1parts_lam(l0, l1, n)
        key = (l0, l1, int(n))
        cached = self._k1parts_lam_cache.get(key)
        if cached is None:
            parts = torch.movedim(self._get_k1parts(l0, l1, n), 0, -1)
            cached = parts.index_select(-1, tr.bitrev_index(int(n), self.device)).contiguous()
            self._k1parts_lam_cache[key] = cached
            if len(self._k1parts_lam_cache) > 24:
                self._k1parts_lam_cache.pop(next(iter(self._k1parts_lam_cache)))
        return cached

    # half-spectrum (rfft) hooks: k1 and y are real, so the single-task
    # solver runs on the Hermitian half spectrum
    def _ft_lam_half(self, k1):
        return tr.rfft_stable_plain(k1)

    def _ft_half(self, v):
        return tr.rfft_stable_lattice(v)

    def _ift_half(self, z_half, n):
        return tr.irfft_br(z_half, n)

    def _ft_half_q(self, v, pre_permuted=False):
        return tr.rfft_stable_plain(v) if pre_permuted else self._ft_half(v)

    def _ift_half_q(self, v, n, pre_permuted=False):
        return tr.irfft_plain(v, n) if pre_permuted else self._ift_half(v, n)

    # permuted-spectrum hooks: same bit-reversed input vector space as the
    # plain-FFT path, spectrum in the kernels' fixed permuted bin order
    def _ft_lam_perm(self, k1):
        return tr.pfft_stable(k1)

    def _ft_perm(self, v):
        """Natural-order input: bit-reverse, then stabilized pfft."""
        return tr.pfft_stable(v.index_select(-1, tr.bitrev_index(v.shape[-1], v.device)))

    def _ift_perm_coeffs(self, z, n):
        """Inverse to natural point order (the coeffs convention)."""
        return tr.pifft_ortho_real(z, n).index_select(-1, tr.bitrev_index(int(n), z.device))

    def _ft_perm_q(self, v, pre_permuted=False):
        return tr.pfft_stable(v) if pre_permuted else self._ft_perm(v)

    def _ift_perm_q(self, z, n, pre_permuted=False):
        out = tr.pifft_ortho_real(z, n)
        return out if pre_permuted else out.index_select(-1, tr.bitrev_index(int(n), z.device))

    # gather-free transforms of query rows in the training columns' bit-reversed order
    def _ft_q(self, v, pre_permuted=False):
        if pre_permuted and self._seq_mesh is None:
            return tr.ft_stable_plain_fft(v)
        return self._ft(v)

    def _ift_q(self, v, pre_permuted=False):
        if pre_permuted and self._seq_mesh is None:
            return tr.ift_stable_plain(v)
        return self._ift(v)

    # cross-kernel queries take the TRAINING columns in bit-reversed order,
    # so the per-chunk transform needs no gather along the long axis (natural
    # order under a sequence mesh)
    def _train_col_perm(self, l, n):
        if self._seq_mesh is not None:
            return None
        if int(n) == 0:
            return np.arange(0, dtype=np.int64)
        return bit_reverse_permutation(log2_int(int(n)))
