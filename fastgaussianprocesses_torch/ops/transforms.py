"""Orthonormal fast transforms diagonalizing lattice and digital-net Gram
matrices (counterpart of ``fastgaussianprocesses_tpu/ops/transforms.py``).

* ``pfft_stable`` / ``pifft_ortho`` / ``pifft_ortho_real`` -- the
  permuted-spectrum FFT of ``ops/perm_fft`` (kernels K1-K3 on the card),
  float32, n = 2^14..2^22.
* ``rfft_stable_*`` / ``irfft_*`` -- the Hermitian half spectrum over
  ``torch.fft``, for float64 and for n below 2^14.
* ``ft_stable_lattice`` / ``ift_stable_lattice`` -- the full spectrum over
  ``torch.fft`` (the general solver's lattice transform, which a single-task
  lattice reaches only at n = 1), and their gather-free forms
  ``ft_stable_plain_fft`` / ``ift_stable_plain``.
* ``ft_stable_fwht`` -- the orthonormal FWHT of ``ops/fwht`` (kernel K4 on
  the card, centring the rows as it loads them), self-inverse;
  ``merge_doubling`` grows a transform from n to 2n.

The stabilized wrappers subtract the mean before transforming and add
``mean * sqrt(n)`` back into the DC bin, avoiding cancellation for
near-constant inputs.  Under a sequence mesh (``parallel/mesh``) the input
is a rank's block of the rows: ``_stabilize`` and ``_centre_on_load`` then
take the group's global mean and add the DC term on rank 0 only.

Every transform is differentiable: ``pfft`` / ``pifft_real`` / ``pifft`` and
``fwht`` are autograd Functions whose backward passes are the kernels again
(K2 for K1 and K1 for K2, K4 for K4).  The in-place updates below touch only
tensors that no backward reads.
"""

import functools
import math

import torch

from ..parallel import comm
from .bitops import bit_reverse_permutation, log2_int
from .fwht import fwht
from .perm_fft import _cdtype, pfft, pifft, pifft_real


def _row_mean(x, group, keepdim):
    """Row means of ``x``, or, with a process group, of the whole rows whose
    blocks the group's ranks hold (a sum over the group by the global n).
    Returns the mean and the global n."""
    if group is None:
        return x.mean(-1, keepdim=keepdim), x.shape[-1]
    n = x.shape[-1] * comm.size(group)
    return comm.all_sum(x.sum(-1, keepdim=keepdim), group) / n, n


def _stabilize(transform, x, group=None):
    """``transform(x - mean)`` with ``mean * sqrt(n)`` added back into the DC
    bin.  With a process group ``x`` is this rank's block of the rows, the
    mean is the global one, and the DC bin lies on rank 0."""
    xmean, n = _row_mean(x, group, True)
    y = transform(x - xmean)
    if comm.rank(group) == 0:
        y[..., 0] += (xmean[..., 0] * math.sqrt(n)).to(y.dtype)
    return y


@functools.lru_cache(maxsize=8)
def bitrev_index(n: int, device: torch.device) -> torch.Tensor:
    """The bit-reversal permutation of length n as an index tensor on ``device``
    (cached: at n = 2^20 it is 8 MB)."""
    return torch.as_tensor(bit_reverse_permutation(log2_int(n)), device=device)


def pfft_stable(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred orthonormal FFT in the permuted spectrum order
    (``perm_fft.spectrum_perm``; DC stays at index 0).  Input already in
    bit-reversed point order."""
    n = x.shape[-1]
    return _stabilize(lambda v: pfft(v, n).mul_(1.0 / math.sqrt(n)), x)


def pifft_ortho(z: torch.Tensor, n: int) -> torch.Tensor:
    """Orthonormal inverse of :func:`pfft_stable`'s transform, complex64;
    output in bit-reversed point order (the space the forward consumed)."""
    return pifft(z, n).mul_(math.sqrt(n))


def pifft_ortho_real(z: torch.Tensor, n: int) -> torch.Tensor:
    """Real part of the orthonormal inverse of :func:`pfft_stable`'s transform;
    output in bit-reversed point order."""
    return pifft_real(z, n).mul_(math.sqrt(n))


def rfft_stable_plain(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred orthonormal rfft of pre-permuted REAL input (n//2 + 1
    bins of the Hermitian spectrum)."""
    n = x.shape[-1]
    if n == 1:
        return x.to(torch.complex128 if x.dtype == torch.float64 else torch.complex64)
    return _stabilize(lambda v: torch.fft.rfft(v).mul_(1.0 / math.sqrt(n)), x)


def rfft_stable_lattice(x: torch.Tensor) -> torch.Tensor:
    """Half-spectrum transform of natural-order input (bit reversal folded in;
    mean-centring commutes with the permutation)."""
    n = x.shape[-1]
    if n == 1:
        return rfft_stable_plain(x)
    return rfft_stable_plain(x.index_select(-1, bitrev_index(n, x.device)))


def irfft_plain(x_half: torch.Tensor, n: int) -> torch.Tensor:
    """Real-space inverse of the orthonormal half-spectrum transform, output
    left in bit-reversed order."""
    if n == 1:
        return x_half.real
    return torch.fft.irfft(x_half, n).mul_(math.sqrt(n))


def irfft_br(x_half: torch.Tensor, n: int) -> torch.Tensor:
    """Real-space inverse of the orthonormal half-spectrum transform, output
    in natural order."""
    if n == 1:
        return x_half.real
    return irfft_plain(x_half, n).index_select(-1, bitrev_index(n, x_half.device))


def _fft_plain(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FFT of input already in bit-reversed order."""
    n = x.shape[-1]
    return torch.fft.fft(x.to(_cdtype(x.dtype))).mul_(1.0 / math.sqrt(n))


def _ifft_plain(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal IFFT, output left in bit-reversed order."""
    return torch.fft.ifft(x).mul_(math.sqrt(x.shape[-1]))


def fftbr(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FFT of the bit-reverse-permuted input:
    ``FFT_ortho(x[rho])``, which diagonalizes natural-order lattice Gram
    matrices."""
    n = x.shape[-1]
    if n == 1:
        return x.to(_cdtype(x.dtype))
    return _fft_plain(x.index_select(-1, bitrev_index(n, x.device)))


def ifftbr(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fftbr`."""
    n = x.shape[-1]
    if n == 1:
        return x
    return _ifft_plain(x).index_select(-1, bitrev_index(n, x.device))


def ft_stable_lattice(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred :func:`fftbr`."""
    return _stabilize(fftbr, x)


def ift_stable_lattice(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred :func:`ifftbr`."""
    return _stabilize(ifftbr, x)


def ft_stable_plain_fft(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred orthonormal FFT of input already in bit-reversed order."""
    return _stabilize(_fft_plain, x)


def ift_stable_plain(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred orthonormal IFFT, output left in bit-reversed order."""
    if x.shape[-1] == 1:
        return x
    return _stabilize(_ifft_plain, x)


def get_omega_lattice(m: int, dtype=torch.complex128) -> torch.Tensor:
    """Twiddles ``exp(-i pi k / 2^m)`` of the lattice doubling merge."""
    k = torch.arange(1 << m, dtype=torch.float64)
    return torch.exp((-1j * math.pi) * k / (1 << m)).to(dtype)


def _centre_on_load(transform, x, group=None):
    """``_stabilize`` for a transform that takes the row means and subtracts
    them as it loads the rows (``transform(x, mean)``): no centred copy."""
    xmean, n = _row_mean(x, group, False)
    y = transform(x.contiguous(), xmean)
    if comm.rank(group) == 0:
        y[..., 0] += (xmean * math.sqrt(n)).to(y.dtype)
    return y


def ft_stable_fwht(x: torch.Tensor) -> torch.Tensor:
    """Mean-centred orthonormal FWHT (self-inverse), kernel K4 on the card.
    There K4 subtracts the row means as it loads the rows, which rounds as
    ``x - xmean`` does, so the result is the same without a centred copy."""
    if x.device.type == "cpu":
        return _stabilize(fwht, x)
    return _centre_on_load(fwht, x)


def merge_doubling(prev: torch.Tensor, new_half_t: torch.Tensor, omega) -> torch.Tensor:
    """One radix-2 merge: from ``prev = ft(v[:n])`` and ``new_half_t =
    ft(v[n:2n])`` the transform ``ft(v[:2n]) = [prev + w new, prev - w new] /
    sqrt(2)``, with ``w`` the lattice twiddles, or 1 for the FWHT."""
    wn = new_half_t * omega
    return torch.cat([prev + wn, prev - wn], -1) * (1.0 / math.sqrt(2.0))
