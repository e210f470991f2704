"""Orthonormal fast Walsh-Hadamard transform: the CUDA kernel K4 and its plain
PyTorch version (counterpart of ``fastgaussianprocesses_tpu/ops/pallas_fwht.py``
and of the contraction ``fwht`` in ``fastgaussianprocesses_tpu/ops/transforms.py``).

``fwht(x) = H_n x / sqrt(n)`` along the last axis, n a power of two, any
leading batch; H_n is the +/-1 Hadamard matrix in Sylvester order, so the
transform is symmetric, orthonormal and its own inverse.

* **K4** :func:`fwht` <- ``pallas_fwht._make_kernel`` (launched by
  ``_fwht_fused``).  ``csrc/fwht.cu`` runs the radix-2 butterflies in shared
  memory in two passes (the 12 lowest index bits, then the rest 10 bits at a
  time); its head comment has the bound and the design.  It takes float32
  and float64, every n and every number of rows: the JAX package's routing
  of some shapes to XLA came from TPU timings and has no counterpart here.
* :func:`fwht_plain` -- the JAX package's contraction: the index split into
  factors of at most 8 bits, one ``tensordot`` with a +/-1 Hadamard block
  per factor.  The wrapper runs it for CPU tensors only.

The two sum in another order, so float32 results differ by a few ulps of
the largest output (tests and ``chip_smoke.py`` state the tolerance).
"""

import ctypes
import functools
import math

import numpy as np
import torch

from . import cuda_lib
from .bitops import log2_int

# launches of K4 since the last reset (the CPU plain version does not count)
launches = {"fwht": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=32)
def _hadamard_np(m: int) -> np.ndarray:
    """Unnormalized +/-1 Hadamard matrix of size 2^m (Sylvester order)."""
    h = np.array([[1.0]])
    for _ in range(m):
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=32)
def _hadamard(m: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The Hadamard block on ``device`` (cached, so that repeated calls copy
    nothing from the host)."""
    return torch.as_tensor(_hadamard_np(m), dtype=dtype, device=device)


def _fwht_factors(m: int) -> list:
    """Split m into factors of at most 8 bits, as the JAX package does."""
    out = []
    while m > 0:
        f = min(m, 8)
        if 0 < m - f < 3 and f > 4:
            f = (m + 1) // 2
        out.append(f)
        m -= f
    return out


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FWHT of the last axis as Hadamard-block contractions."""
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    factors = _fwht_factors(log2_int(n))
    batch = tuple(x.shape[:-1])
    y = x.reshape((-1,) + tuple(1 << f for f in factors))
    for axis, f in enumerate(factors):
        y = torch.movedim(torch.tensordot(y, _hadamard(f, x.dtype, x.device),
                                          dims=([axis + 1], [1])), -1, axis + 1)
    return y.reshape(batch + (n,)) * (1.0 / math.sqrt(n))


def _fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"fwht: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64) or not x.is_contiguous():
        raise ValueError(f"fwht: need a contiguous float32 or float64 tensor, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    n = x.shape[-1]
    out = torch.empty_like(x)
    lib = cuda_lib.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fgp_fwht(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                           x.numel() // n, log2_int(n), int(x.dtype == torch.float64),
                           ctypes.c_void_p(stream))
    cuda_lib.check(lib, err, "fgp_fwht")
    launches["fwht"] += 1
    return out


def fwht(x: torch.Tensor) -> torch.Tensor:
    """K4: orthonormal FWHT of the last axis (length a power of two).  CPU
    tensors take the plain version; any other tensor launches the kernel or
    raises."""
    n = x.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"fwht: the last axis must have a power-of-two length, got {n}")
    if x.device.type == "cpu":
        return fwht_plain(x)
    return _fwht_cuda(x)
