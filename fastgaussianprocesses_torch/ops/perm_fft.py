r"""Permuted-spectrum FFT on the card: the CUDA kernels K1-K3, their plain
PyTorch versions and a plain-PyTorch emulation of the kernels' algorithm
(counterpart of ``fastgaussianprocesses_tpu/ops/pallas_fft.py``).

Output bin order is the JAX package's, copied exactly (``_plan``,
``spectrum_perm``), so spectra agree bin for bin and the solver state can be
compared directly.  ``_plan``'s factorization::

    n = A0 * B0,  B0 = Bh * Bl,   j = a*B0 + bh*Bl + bl,   k = k1 + A0*kh + A0*Bh*kl

and the spectrum comes back as ``(Bh, A0, Bl)``: ``X_p.reshape(Bh, A0,
Bl)[kh, k1, kl] == X[k1 + A0*kh + A0*Bh*kl]``, a fixed permutation with DC at
index 0.  The plain versions compute it that way (pass A as ``torch.matmul``
on float32 planes, then ``passb_plain``: twiddle, DFT over bh, twiddle, DFT
over bl, with the float64-built tables of ``_tables``).

Kernels (``csrc/perm_fft.cu``; each wrapper launches them for CUDA tensors,
runs its plain version for CPU tensors, and raises for anything else).  All
three run on one split of n, :func:`_slab_plan` (A = 256, B = 2^12 at
n = 2^20): pass A as a length-A FFT (``pass_a_kernel``), and one block per
(row, k1) slab for the length-B DFT of bins ``k1 + A*k2`` as Stockham
radix-16 passes, each op two launches:

* **K1** :func:`pfft` <- ``pallas_fft._passb_kernel`` (the whole ``pfft``):
  pass A on real or complex rows, then ``pfft_slab_kernel``, which applies
  the twiddle w_n^{k1 b} on the load and writes each slab's bins straight
  into their ``spectrum_perm`` places, as B/128 runs of 128 values
  (:func:`slab_scatter_index`).
* **K2** :func:`pifft_real` and :func:`pifft` <- ``pallas_fft._passb_inv_kernel``
  (the whole ``pifft_real`` and ``pifft``): ``ifft(X) = conj(fft(conj X)) / n``
  with K1's tables and code in the other order: ``pifft_slab_kernel`` gathers
  each slab's runs conjugated, runs the forward slab DFT and the twiddle
  after it, then pass A keeps the real part (``pifft_real``) or the whole
  conjugated value (``pifft``, complex64), scaled by 1/n, in natural order.
* **K3** :func:`quad_partials` <- ``pallas_fft._quad_kernel`` (``pfft_quad``):
  ``sum w |Z|^2`` over the spectrum of mean-centred real rows (centred as
  pass A loads them), the spectrum never written whole: pass A writes only
  the slabs k1 = 0..A/2 (for real rows slab A - k1 is the conjugate mirror
  of slab k1), and ``quad_slab_kernel`` sums with the folded weights of
  :func:`fold_weights`.  One partial sum per (row, k1 <= A/2), reduced in a
  fixed order; ``torch.sum`` over them follows, so the result is
  deterministic (no atomics).

Each kernel carries its row in ``blockIdx.y``, which CUDA caps at 65535, so
the wrappers launch the rows in blocks of at most :data:`MAX_GRID_ROWS`
(:func:`row_blocks`), the scratch reused from block to block; the
arithmetic of a row does not depend on its block.

Autograd: :func:`pfft`, :func:`pifft_real` and :func:`pifft` are autograd
Functions whose backwards are the kernels again, so a differentiated loss on
the card runs K1 and K2 and nothing else: the backward of ``pfft`` is
``n * pifft_real(g)`` on real rows and ``n * pifft(g)`` on complex rows, that
of ``pifft_real`` and of ``pifft`` is ``pfft(g) / n``, in PyTorch's
convention for complex gradients (``dL/dRe + i dL/dIm``).  :func:`pfft_quad`
has no backward and raises if asked for one.

Bound on the H100 (by bytes): ``pfft`` of a real n = 2^20 row reads 4 MB and
writes 8 MB, ``pifft_real`` the reverse, ~3.6 us at 3.35 TB/s; K3 reads the
row once; ``pifft`` reads and writes 8 MB, ~5.0 us.  The (R, A, B) complex
scratch between the two launches (8 MB at n = 2^20, R = 1) stays in the
50 MB L2.  :func:`pfft_emulate`, :func:`pifft_real_emulate`,
:func:`pifft_emulate` and :func:`quad_emulate` are the kernels' algorithms
in plain PyTorch, which the CPU tests hold against numpy and the JAX
package.

Inputs are float32; the plain versions' matmuls run at full float32
precision (TF32 is off, see ``config``), as the JAX package leaves them to
XLA.
"""

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib
from .bitops import log2_int

_MIN_M = 14           # below this torch.fft is used (half-spectrum solver)
_MAX_M = 22

# CUDA's limit on gridDim.y, which carries the row index in every K1-K3 launch:
# the wrappers launch rows in blocks of at most this many (read at each call)
MAX_GRID_ROWS = 65535

# launches of each kernel op since the last reset (one per block of at most MAX_GRID_ROWS
# rows, itself two kernel launches; the CPU plain versions do not count)
launches = {"pfft": 0, "pifft_real": 0, "pifft": 0, "quad": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supported(n: int) -> bool:
    return n == (n & -n) and _MIN_M <= log2_int(n) <= _MAX_M


@functools.lru_cache(maxsize=None)
def _plan(n: int):
    """(A, Bh, Bl, K1B) exactly as the JAX package plans them (K1B is the
    TPU kernel's k1 block and unused here).  It fixes the spectrum's bin
    order; the plain versions compute on it."""
    if n >= (1 << 17):
        A = max(64, min(256, n >> 14))
    else:
        A = 128
    B = n // A
    Bl = min(128, B)
    Bh = B // Bl
    K1B = min(128, A)
    while K1B > 8 and 6 * K1B * B * 8 > (8 << 20):
        K1B //= 2
    return A, Bh, Bl, K1B


@functools.lru_cache(maxsize=None)
def _slab_plan(n: int):
    """The kernels' split n = A * B: A in {64, 128, 256}, with B = n / A at
    most 2^12 where A = 256 allows it (2^13 and 2^14 at n = 2^21 and 2^22),
    so that a slab (32 KB at B = 2^12) leaves room for several blocks an SM
    and its FFT takes three radix-16 passes.  A is ``_plan``'s A, twice or
    four times it (the two coincide at n <= 2^18 and at 2^22).  Returns
    (A, B)."""
    A = min(256, max(_plan(n)[0], n >> 12))
    return A, n // A


@functools.lru_cache(maxsize=None)
def _tables(n: int, inverse: bool):
    """Host-side DFT/twiddle tables of ``_plan``'s factorization (the plain
    versions): built in float64, stored as float32 (re, im) numpy pairs."""
    A, Bh, Bl, _ = _plan(n)
    B = Bh * Bl
    sign = +1.0 if inverse else -1.0

    def w(num, den):
        ph = (sign * 2.0 * np.pi / den) * num
        return np.cos(ph), np.sin(ph)

    def dft(m):
        j = np.arange(m, dtype=np.float64)
        return w(np.outer(j, j), m)

    FA = dft(A)
    FBh = dft(Bh)
    FBl = dft(Bl)
    k1 = np.arange(A, dtype=np.float64)[:, None]
    T1 = w(k1 * np.arange(Bh, dtype=np.float64)[None, :] * Bl, n)
    T2 = w(k1 * np.arange(Bl, dtype=np.float64)[None, :], n)
    T3 = w(np.outer(np.arange(Bh, dtype=np.float64),
                    np.arange(Bl, dtype=np.float64)), B)
    to32 = lambda p: (np.ascontiguousarray(p[0], dtype=np.float32),
                      np.ascontiguousarray(p[1], dtype=np.float32))
    return {"FA": to32(FA), "FBh": to32(FBh), "FBl": to32(FBl),
            "T1": to32(T1), "T2": to32(T2), "T3": to32(T3)}


@functools.lru_cache(maxsize=None)
def spectrum_perm(n: int) -> np.ndarray:
    """``perm`` with ``X_permuted[p] == X_natural[perm[p]]``."""
    A, Bh, Bl, _ = _plan(n)
    kh = np.arange(Bh)[:, None, None]
    k1 = np.arange(A)[None, :, None]
    kl = np.arange(Bl)[None, None, :]
    return (k1 + A * kh + A * Bh * kl).reshape(n)


@functools.lru_cache(maxsize=None)
def slab_scatter_index(n: int) -> np.ndarray:
    """(A*B,) positions in the permuted spectrum of the kernels' bins: entry
    ``k1*B + k2`` is where bin ``k1 + A*k2`` goes, (A, B) = ``_slab_plan(n)``,
    computed as K1 and K2 compute it.  With A0 = ``_plan(n)[0]``, c = A/A0,
    k1 = k1h*A0 + k1' and G = B/128, bin k2 = g + G*kl of slab k1 is kl of
    the run kh = k1h + c*g: position (kh*A0 + k1')*128 + kl.  Equals
    ``argsort(spectrum_perm(n))[k1 + A*k2]``."""
    A, B = _slab_plan(n)
    A0 = _plan(n)[0]
    k1 = np.arange(A)[:, None]
    k2 = np.arange(B)[None, :]
    G = B // 128
    kh = k1 // A0 + (A // A0) * (k2 % G)
    return (((kh * A0 + k1 % A0) << 7) + k2 // G).reshape(-1)


def _pairs(ph):
    """Interleaved float32 (re, im) pairs of exp(i*ph), ph in float64."""
    return np.ascontiguousarray(np.stack([np.cos(ph), np.sin(ph)], -1), dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _dev_tables(n: int, inverse: bool, device: torch.device) -> dict:
    """``_tables`` on ``device``, as (re, im) float32 tensor pairs."""
    return {k: (torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))
            for k, (re, im) in _tables(n, inverse).items()}


@functools.lru_cache(maxsize=32)
def _dev_slab_tables(n: int, device: torch.device) -> dict:
    """The kernels' forward tables on ``_slab_plan``'s split (A, B), B = Bh * 128,
    as interleaved float32 pairs built in float64: w_A^j (j < A); w_B^j
    (j < 128), then w_B^{128 j} (j < Bh); tw 1 w_n^{k1 b} (k1 < A) as
    w_n^{128 k1 bh} (A, Bh) and w_n^{k1 bl} (A, 128)."""
    A, B = _slab_plan(n)
    Bl = 128
    Bh = B // Bl
    k1 = np.arange(A, dtype=np.float64)[:, None]
    out = {}
    for key, ph in (("twa", 2 * np.pi / A * np.arange(A)),
                    ("qtw", 2 * np.pi / B * np.concatenate([np.arange(Bl),
                                                             Bl * np.arange(Bh)])),
                    ("qt1", 2 * np.pi / n * k1 * Bl * np.arange(Bh)),
                    ("qt2", 2 * np.pi / n * k1 * np.arange(Bl))):
        out[key] = torch.from_numpy(_pairs(-ph)).to(device)
    return out


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


# ---------------------------------------------------------------------------
# plain PyTorch versions (_plan's factorization and tables; any device)
# ---------------------------------------------------------------------------

def _passb_stages(yr, yi, t):
    """(R, A, Bh, Bl) twiddled-in planes -> (R, A, Bh, Bl) = (r, k1, kh, kl)."""
    FBhr, FBhi = t["FBh"]
    FBlr, FBli = t["FBl"]
    zr = (torch.einsum("hb,rkbl->rkhl", FBhr, yr)
          - torch.einsum("hb,rkbl->rkhl", FBhi, yi))
    zi = (torch.einsum("hb,rkbl->rkhl", FBhr, yi)
          + torch.einsum("hb,rkbl->rkhl", FBhi, yr))
    zr, zi = _cmul(zr, zi, t["T3"][0], t["T3"][1])
    return zr @ FBlr - zi @ FBli, zr @ FBli + zi @ FBlr


def _twiddle1(yr, yi, t):
    T1r, T1i = t["T1"]
    T2r, T2i = t["T2"]
    yr, yi = _cmul(yr, yi, T1r[:, :, None], T1i[:, :, None])
    return _cmul(yr, yi, T2r[:, None, :], T2i[:, None, :])


def _pass_a(xr, xi, n: int):
    """Natural (R, n) planes -> (R, A, B) k1-major planes: Y = F_A @ x."""
    A = _plan(n)[0]
    FAr, FAi = _dev_tables(n, False, xr.device)["FA"]
    x3r = xr.reshape(-1, A, n // A)
    if xi is None:
        return FAr @ x3r, FAi @ x3r
    x3i = xi.reshape(-1, A, n // A)
    return FAr @ x3r - FAi @ x3i, FAi @ x3r + FAr @ x3i


def passb_plain(Yr, Yi, n: int):
    """Pass B of ``_plan``: (R, A, B) k1-major pass-A planes -> (R, n)
    permuted spectrum planes."""
    A, Bh, Bl, _ = _plan(n)
    R = Yr.shape[0]
    t = _dev_tables(n, False, Yr.device)
    yr, yi = _twiddle1(Yr.reshape(R, A, Bh, Bl), Yi.reshape(R, A, Bh, Bl), t)
    outr, outi = _passb_stages(yr, yi, t)
    return (outr.permute(0, 2, 1, 3).reshape(R, n),
            outi.permute(0, 2, 1, 3).reshape(R, n))


def passb_inv_plain(Xr, Xi, n: int):
    """Pass B of ``_plan`` undone: (R, n) permuted spectrum -> (R, A, B)
    k1-major pre-pass-A planes (inverse tables; no 1/n)."""
    A, Bh, Bl, _ = _plan(n)
    R = Xr.shape[0]
    t = _dev_tables(n, True, Xr.device)
    xr = Xr.reshape(R, Bh, A, Bl).permute(0, 2, 1, 3)       # (r, k1, kh, kl)
    xi = Xi.reshape(R, Bh, A, Bl).permute(0, 2, 1, 3)
    FBhr, FBhi = t["FBh"]
    FBlr, FBli = t["FBl"]
    zr, zi = xr @ FBlr - xi @ FBli, xr @ FBli + xi @ FBlr    # undo DFT_Bl
    zr, zi = _cmul(zr, zi, t["T3"][0], t["T3"][1])           # undo tw 2
    yr = (torch.einsum("bh,rkhl->rkbl", FBhr, zr)            # undo DFT_Bh
          - torch.einsum("bh,rkhl->rkbl", FBhi, zi))
    yi = (torch.einsum("bh,rkhl->rkbl", FBhr, zi)
          + torch.einsum("bh,rkhl->rkbl", FBhi, zr))
    yr, yi = _twiddle1(yr, yi, t)                            # undo tw 1
    return yr.reshape(R, A, Bh * Bl), yi.reshape(R, A, Bh * Bl)


def pfft_plain(x, n: int):
    """Plain K1: (R, n) real or complex rows -> (R, n) complex64 permuted
    spectrum; pass A as matmuls on float32 planes, then :func:`passb_plain`."""
    if x.is_complex():
        xr = x.real.to(torch.float32).contiguous()
        xi = x.imag.to(torch.float32).contiguous()
    else:
        xr, xi = x.to(torch.float32).contiguous(), None
    Yr, Yi = _pass_a(xr, xi, n)
    R = xr.shape[0]
    outr, outi = passb_plain(Yr.reshape(R, n), Yi.reshape(R, n), n)
    return torch.complex(outr, outi)


def pifft_real_plain(X, n: int):
    """Plain K2: (R, n) permuted spectrum -> (R, n) float32 real part of its
    inverse (1/n included): :func:`passb_inv_plain`, then the inverse pass A
    as matmuls, without forming the imaginary plane."""
    Xr = X.real.to(torch.float32).contiguous()
    Xi = X.imag.to(torch.float32).contiguous()
    Yr, Yi = passb_inv_plain(Xr, Xi, n)
    FAr, FAi = _dev_tables(n, True, X.device)["FA"]
    xr = (FAr * (1.0 / n)) @ Yr - (FAi * (1.0 / n)) @ Yi
    return xr.reshape(-1, n)


def pifft_plain(X, n: int):
    """Plain K2 with complex output: (R, n) permuted spectrum -> (R, n)
    complex64 inverse (1/n included): :func:`passb_inv_plain`, then the
    inverse pass A as matmuls on both planes."""
    X = X.to(torch.complex64)
    Yr, Yi = passb_inv_plain(X.real.contiguous(), X.imag.contiguous(), n)
    FAr, FAi = _dev_tables(n, True, X.device)["FA"]
    FAr, FAi = FAr * (1.0 / n), FAi * (1.0 / n)
    return torch.complex((FAr @ Yr - FAi @ Yi).reshape(-1, n),
                         (FAr @ Yi + FAi @ Yr).reshape(-1, n))


def quad_plain(xm, wk, n: int):
    """Plain K3: mean-centred (R, n) rows and (Bh, A, Bl) weights ->
    (R, A) partial sums ``sum_{kh,kl} wk[kh, k1, kl] |pfft(xm)[kh, k1, kl]|^2``."""
    A, Bh, Bl, _ = _plan(n)
    R = xm.shape[0]
    t = _dev_tables(n, False, xm.device)
    x3 = xm.reshape(R, A, Bh * Bl)
    yr, yi = t["FA"][0] @ x3, t["FA"][1] @ x3                # pass A (real input)
    yr, yi = _twiddle1(yr.reshape(R, A, Bh, Bl), yi.reshape(R, A, Bh, Bl), t)
    zr, zi = _passb_stages(yr, yi, t)                        # (r, k1, kh, kl)
    return torch.einsum("rkhl,hkl->rk", zr * zr + zi * zi, wk)


# ---------------------------------------------------------------------------
# the kernels' algorithm in plain PyTorch (any device, float32 or float64)
# ---------------------------------------------------------------------------

def _cdtype(dtype):
    return torch.complex128 if dtype in (torch.float64, torch.complex128) else torch.complex64


def _dft_mat(m: int, dtype):
    j = np.arange(m)
    ph = (-2 * np.pi / m) * np.outer(j, j)
    return torch.complex(torch.from_numpy(np.cos(ph)), torch.from_numpy(np.sin(ph))).to(dtype)


def _expi(ph, dtype):
    return torch.complex(torch.cos(ph), torch.sin(ph)).to(dtype)


def _tw1(n: int, slabs: int, dtype):
    """tw 1 of the first ``slabs`` slabs: (slabs, B) w_n^{k1 b}."""
    B = _slab_plan(n)[1]
    return _expi((-2 * np.pi / n) * torch.outer(torch.arange(slabs), torch.arange(B)).double(),
                 dtype)


def pass_a_emulate(x, n: int, half: bool = False):
    """Pass A as ``pass_a_kernel`` factors it: real or complex (R, n) rows ->
    (R, A, B) complex ``Y[k1, b] = sum_a x[a*B + b] w_A^{a k1}``, only the
    slabs k1 <= A/2 when ``half`` (K3).  (A, B) = ``_slab_plan(n)``,
    A = A1*A2, a = A2*a1 + a2, k1 = p + A1*q."""
    A = _slab_plan(n)[0]
    A1 = 8 if A == 64 else 16
    A2 = A // A1
    R, B = x.shape[0], n // A
    cdt = _cdtype(x.dtype)
    x = x.reshape(R, A1, A2, B).to(cdt)                                 # [r, a1, a2, b]
    u = torch.einsum("ip,riab->rapb", _dft_mat(A1, cdt), x)            # [r, a2, p, b]
    a2p = torch.outer(torch.arange(A2), torch.arange(A1)).double()
    u = u * _expi((-2 * np.pi / A) * a2p, cdt)[None, :, :, None]
    y = torch.einsum("aq,rapb->rqpb", _dft_mat(A2, cdt), u)            # [r, q, p, b]
    y = y.reshape(R, A, B)
    return y[:, :A // 2 + 1] if half else y


def slab_dft(z, n: int):
    """The slab kernels' length-B DFT of the last axis (B = ``_slab_plan(n)[1]``)
    as their Stockham passes: radix 2^(log2 B mod 4) first, then 16s."""
    B = _slab_plan(n)[1]
    m = log2_int(B)
    cdt = z.dtype
    radices = ([1 << (m % 4)] if m % 4 else []) + [16] * (m // 4)
    ns = 1
    for r in radices:
        j = torch.arange(B // r)
        k = j % ns
        q = torch.arange(r)
        v = z[..., j[None, :] + (B // r) * q[:, None]]                 # [.., q, j]
        v = v * _expi((-2 * np.pi / (ns * r)) * torch.outer(q, k).double(), cdt)
        v = torch.einsum("qp,...qj->...pj", _dft_mat(r, cdt), v)
        dest = (j // ns) * ns * r + k
        out = torch.empty_like(z)
        out[..., dest[None, :] + ns * q[:, None]] = v
        z, ns = out, ns * r
    return z


@functools.lru_cache(maxsize=8)
def _scatter_index(n: int, device: torch.device):
    return torch.from_numpy(slab_scatter_index(n)).to(device)


def pfft_emulate(x, n: int):
    """K1's two launches in plain PyTorch: (R, n) real or complex rows ->
    (R, n) permuted spectrum (complex64, or complex128 from float64)."""
    A = _slab_plan(n)[0]
    y = pass_a_emulate(x, n)
    z = slab_dft(y * _tw1(n, A, y.dtype), n)                  # [r, k1, k2] = X[k1 + A k2]
    out = torch.empty((x.shape[0], n), dtype=z.dtype, device=z.device)
    out[:, _scatter_index(n, z.device)] = z.reshape(-1, n)
    return out


def _pifft_unscaled_emulate(X, n: int):
    """K2's two launches in plain PyTorch before the store: (R, n) permuted
    spectrum -> (R, n) ``fft(conj X)`` in natural order."""
    A, B = _slab_plan(n)
    z = X.index_select(-1, _scatter_index(n, X.device)).reshape(-1, A, B).conj()
    y = slab_dft(z, n)
    y = y * _tw1(n, A, y.dtype)                               # tw 1 after the slab DFT
    return pass_a_emulate(y.reshape(-1, n), n).reshape(-1, n)


def pifft_real_emulate(X, n: int):
    """K2 in plain PyTorch: (R, n) permuted spectrum -> (R, n) real part of
    its inverse (1/n included), as ``Re(fft(conj X)) / n``."""
    return _pifft_unscaled_emulate(X, n).real * (1.0 / n)


def pifft_emulate(X, n: int):
    """K2 with complex output in plain PyTorch: (R, n) permuted spectrum ->
    (R, n) inverse (1/n included), as ``conj(fft(conj X)) / n``."""
    return _pifft_unscaled_emulate(X, n).conj() * (1.0 / n)


def quad_slab_sums(y, wf, n: int):
    """K3's slab phase in plain PyTorch: (R, A/2+1, B) half pass-A output and
    (A/2+1, B) folded weights -> (R, A/2+1) per-slab sums
    ``sum_k2 wf[k1, k2] |DFT_B(w_n^{k1 b} Y[k1, b])[k2]|^2``."""
    z = slab_dft(y * _tw1(n, y.shape[1], y.dtype), n)
    return torch.einsum("rkb,kb->rk", z.real ** 2 + z.imag ** 2, wf.to(z.real.dtype))


@functools.lru_cache(maxsize=None)
def _fold_index(n: int):
    """Indices into the flat permuted weights for K3's folded weights, on
    ``_slab_plan``'s split (A, B): ``idx`` (A/2+1, B) of bin k = k1 + A*k2,
    and ``mirror`` (A/2-1, B) of bin n - k for the slabs 1 <= k1 < A/2, whose
    conjugate mirror slab A - k1 is not computed (slabs 0 and A/2 hold both
    bins of every pair)."""
    A = _slab_plan(n)[0]
    inv = np.argsort(spectrum_perm(n))          # inv[k]: permuted position of bin k
    k = np.arange(A // 2 + 1)[:, None] + A * np.arange(n // A)[None, :]
    return inv[k], inv[n - k[1:A // 2]]


@functools.lru_cache(maxsize=32)
def _dev_fold_index(n: int, device: torch.device):
    return tuple(torch.from_numpy(i.reshape(-1)).to(device) for i in _fold_index(n))


def fold_weights(wk, n: int):
    """(Bh, A0, Bl) permuted weights -> (A/2+1, B) folded weights ``w'[k1, k2]``
    of bin k = k1 + A*k2: ``w_k + w_{n-k}`` for 1 <= k1 < A/2, ``w_k`` for
    k1 = 0 and A/2.  For a real row, ``sum_k w_k |X_k|^2 ==
    sum_{k1 <= A/2, k2} w'[k1, k2] |X_{k1 + A k2}|^2``.  A zeroed DC weight
    stays zero: bin 0 lies in slab 0, which is not folded.  (A, B) is
    ``_slab_plan(n)``."""
    A = _slab_plan(n)[0]
    idx, mirror = _dev_fold_index(n, wk.device)
    flat = wk.reshape(-1)
    wf = flat.index_select(0, idx).reshape(A // 2 + 1, n // A)
    wf[1:A // 2] += flat.index_select(0, mirror).reshape(A // 2 - 1, n // A)
    return wf


def quad_emulate(x, wk, n: int, mean):
    """K3's two-phase algorithm in plain PyTorch (any device, float32 or
    float64): (R, n) rows, centred by subtracting ``mean`` (R,), and
    (Bh, A0, Bl) weights -> (R, A/2+1) per-slab partial sums, whose row sums
    equal those of :func:`quad_plain` on the centred rows."""
    y = pass_a_emulate(x - mean[:, None], n, half=True)
    return quad_slab_sums(y, fold_weights(wk, n), n)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(t, shape, what):
    if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous float32 tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs a CUDA tensor, got {t.device}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def row_blocks(R: int, cap: int):
    """``(r0, r1)`` blocks of at most ``cap`` consecutive rows covering
    ``range(R)``: one kernel launch each."""
    return [(r0, min(R, r0 + cap)) for r0 in range(0, R, cap)]


def _launch(fn, name, dev, *args):
    """Call the C entry point ``fn`` on ``dev``'s current stream; raise on a
    CUDA error."""
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    cuda_lib.check(lib, err, fn)
    launches[name] += 1


def _as_planes(z, n: int, what: str):
    """Complex (R, n) -> its interleaved float32 (R, n, 2) view (copied to
    complex64 and contiguous first where needed), checked for the kernels."""
    v = torch.view_as_real(z.to(torch.complex64).resolve_conj().contiguous())
    _check(v, (z.shape[0], n, 2), what)
    return v


def _pfft_cuda(x, n: int, out=None):
    """K1 on CUDA rows.  ``out``, a test hook: a caller-owned (R, n)
    complex64 output (a test fills it with NaN to see that every row block
    is written); no path in the package passes it."""
    R = x.shape[0]
    if x.is_complex():
        xin = _as_planes(x, n, "pfft rows")
    else:
        xin = x.to(torch.float32).contiguous()
        _check(xin, (R, n), "pfft rows")
    if out is None:
        out = torch.empty((R, n), dtype=torch.complex64, device=x.device)
    _check(torch.view_as_real(out), (R, n, 2), "pfft output")
    A, B = _slab_plan(n)
    t = _dev_slab_tables(n, x.device)
    blocks = row_blocks(R, MAX_GRID_ROWS)
    y = torch.empty((min(R, MAX_GRID_ROWS), A, B, 2), dtype=torch.float32, device=x.device)
    for r0, r1 in blocks:
        _launch("fgp_pfft", "pfft", x.device, _ptr(xin[r0:r1]), int(x.is_complex()),
                *[_ptr(t[k]) for k in ("twa", "qt1", "qt2", "qtw")], _ptr(y),
                _ptr(out[r0:r1]), r1 - r0, A, log2_int(_plan(n)[0]), log2_int(B))
    return out


def _k2_cuda(X, n: int, out, name: str):
    """K2 on CUDA spectra, the real part (``name`` ``"pifft_real"``: float32
    output) or the whole inverse (``"pifft"``: complex64 output)."""
    R = X.shape[0]
    Xin = _as_planes(X, n, f"{name} spectrum")
    real = name == "pifft_real"
    if out is None:
        out = torch.empty((R, n), dtype=torch.float32 if real else torch.complex64,
                          device=X.device)
    _check(out if real else torch.view_as_real(out), (R, n) if real else (R, n, 2),
           f"{name} output")
    A, B = _slab_plan(n)
    t = _dev_slab_tables(n, X.device)
    blocks = row_blocks(R, MAX_GRID_ROWS)
    y = torch.empty((min(R, MAX_GRID_ROWS), A, B, 2), dtype=torch.float32, device=X.device)
    for r0, r1 in blocks:
        _launch("fgp_" + name, name, X.device, _ptr(Xin[r0:r1]),
                *[_ptr(t[k]) for k in ("twa", "qt1", "qt2", "qtw")], _ptr(y),
                _ptr(out[r0:r1]), r1 - r0, A, log2_int(_plan(n)[0]), log2_int(B))
    return out


def _pifft_real_cuda(X, n: int, out=None):
    """K2 on CUDA spectra.  ``out``, a test hook as in :func:`_pfft_cuda`: a
    caller-owned (R, n) float32 output."""
    return _k2_cuda(X, n, out, "pifft_real")


def _pifft_cuda(X, n: int, out=None):
    """K2 with complex output on CUDA spectra.  ``out``, a test hook as in
    :func:`_pfft_cuda`: a caller-owned (R, n) complex64 output."""
    return _k2_cuda(X, n, out, "pifft")


def quad_partials(x, wk, n: int, mean, out=None):
    """K3: (R, n) float32 rows ``x``, their (R,) means and (Bh, A0, Bl)
    weights -> per-row partial sums of ``wk * |pfft(x - mean)|^2``: (R, A0)
    per k1 of ``_plan(n)`` from the plain version for CPU tensors,
    (R, A/2+1) per half-spectrum slab of ``_slab_plan(n)`` from the two
    kernels for CUDA tensors.  The kernel centres a row as it loads it, so
    the caller writes no centred copy.  ``out``, a test hook as in
    :func:`_pfft_cuda`: a caller-owned (R, A/2+1) float32 output for the
    kernels."""
    if x.device.type == "cpu":
        return quad_plain(x - mean[:, None], wk, n)
    R = x.shape[0]
    _check(x, (R, n), "quad rows")
    _check(mean, (R,), "quad row means")
    A0, Bh, Bl, _ = _plan(n)
    _check(wk, (Bh, A0, Bl), "quad weights")
    A, B = _slab_plan(n)
    t = _dev_slab_tables(n, x.device)
    wf = fold_weights(wk, n)
    H = A // 2 + 1
    blocks = row_blocks(R, MAX_GRID_ROWS)
    y = torch.empty((min(R, MAX_GRID_ROWS), H, B, 2), dtype=torch.float32, device=x.device)
    partial = torch.empty((R, H), dtype=torch.float32, device=x.device) if out is None else out
    _check(partial, (R, H), "quad partials")
    for r0, r1 in blocks:
        _launch("fgp_quad", "quad", x.device,
                *[_ptr(v) for v in (x[r0:r1], mean[r0:r1], t["twa"], t["qt1"], t["qt2"],
                                    t["qtw"], wf, y, partial[r0:r1])],
                r1 - r0, A, log2_int(B))
    return partial


# ---------------------------------------------------------------------------
# public ops (complex in/out), differentiable
# ---------------------------------------------------------------------------

def _flatten_batch(x, n):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, n), lead


def _owned(t):
    """``t``, copied if it is a view: an autograd Function must return tensors
    that later in-place updates may change (``pfft_stable``'s DC bump)."""
    return t.clone() if t._base is not None else t


def _pfft_rows(x2, n: int):
    return _owned(pfft_plain(x2, n)) if x2.device.type == "cpu" else _pfft_cuda(x2, n)


def _pifft_real_rows(X2, n: int):
    return (_owned(pifft_real_plain(X2, n)) if X2.device.type == "cpu"
            else _pifft_real_cuda(X2, n))


def _pifft_rows(X2, n: int):
    return _owned(pifft_plain(X2, n)) if X2.device.type == "cpu" else _pifft_cuda(X2, n)


class _Pfft(torch.autograd.Function):
    """K1 on (R, n) rows.  In PyTorch's convention (``grad = dL/dRe + i
    dL/dIm``) the backward of the C-linear ``y = P F x`` is ``F^H P^T g =
    n * ifft(P^T g) = n * pifft(g)``: K2 with complex output on complex
    rows, and on real rows its real part ``n * pifft_real(g)``, with no
    conjugation (the JAX package's ``n conj(pifft(conj g))`` is the same map
    in JAX's convention)."""

    @staticmethod
    def forward(ctx, x2, n):
        ctx.n, ctx.dtype, ctx.complex_in = n, x2.dtype, x2.is_complex()
        return _pfft_rows(x2, n)

    @staticmethod
    def backward(ctx, g):
        inv = pifft(g, ctx.n) if ctx.complex_in else pifft_real(g, ctx.n)
        return (inv * float(ctx.n)).to(ctx.dtype), None


class _PifftReal(torch.autograd.Function):
    """K2 on (R, n) spectra.  The backward of ``y = Re(F^-1 P^T X)`` is
    ``P F^-H g = pfft(g) / n`` on the real cotangent: K1."""

    @staticmethod
    def forward(ctx, X2, n):
        ctx.n, ctx.dtype = n, X2.dtype
        return _pifft_real_rows(X2, n)

    @staticmethod
    def backward(ctx, g):
        return (pfft(g, ctx.n) * (1.0 / ctx.n)).to(ctx.dtype), None


class _Pifft(torch.autograd.Function):
    """K2 with complex output on (R, n) spectra.  ``x = (1/n) F^H P^T X`` is
    C-linear, so in PyTorch's convention its backward is the adjoint
    ``(1/n) (F^H P^T)^H g = (1/n) P F g = pfft(g) / n``: K1 on complex rows
    (the JAX package's ``conj(pfft(conj g)) / n`` is the same map in JAX's
    convention).  For a real spectrum only the real part is kept."""

    @staticmethod
    def forward(ctx, X2, n):
        ctx.n, ctx.dtype, ctx.complex_in = n, X2.dtype, X2.is_complex()
        return _pifft_rows(X2, n)

    @staticmethod
    def backward(ctx, g):
        gx = pfft(g, ctx.n) * (1.0 / ctx.n)
        return (gx if ctx.complex_in else gx.real).to(ctx.dtype), None


def pfft(x, n: int):
    """Unnormalized DFT of the last axis in PERMUTED spectrum order
    (``spectrum_perm``), through K1 on the card.  ``x`` real or complex;
    returns complex64.  Differentiable (its backward is K2: ``pifft_real``
    for real ``x``, ``pifft`` for complex ``x``)."""
    x2, lead = _flatten_batch(x, n)
    return _Pfft.apply(x2, n).reshape(lead + (n,))


def pifft_real(X, n: int):
    """Real part of the inverse of :func:`pfft` (includes 1/n), through K2 on
    the card: permuted spectrum in, natural order out, float32, without
    forming the imaginary part.  Differentiable (its backward is K1)."""
    X2, lead = _flatten_batch(X, n)
    return _PifftReal.apply(X2, n).reshape(lead + (n,))


def pifft(X, n: int):
    """Inverse of :func:`pfft` (includes 1/n), through K2 on the card:
    permuted spectrum in, natural order out, complex64.  Differentiable (its
    backward is K1)."""
    X2, lead = _flatten_batch(X, n)
    return _Pifft.apply(X2, n).reshape(lead + (n,))


def pfft_quad(x, w, n: int):
    """``sum_b w_b * |pfft_stable(x)_b|^2`` per row, through K3.

    ``w``: real (n,) weights in permuted bin order; the 1/n orthonormal
    normalization is folded in.  The stabilization is the JAX package's:
    the row mean is taken here and subtracted from the row (by the kernel as
    it loads the row), and the exact DC term ``w_0 * n * mean^2`` is added
    here.  Not differentiable (query paths only): raises if an input
    requires grad, rather than cut the graph."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError("pfft_quad has no backward (query paths only)")
    A, Bh, Bl, _ = _plan(n)
    x2, lead = _flatten_batch(x, n)
    x2 = x2.to(torch.float32).contiguous()
    m = x2.mean(-1)
    w32 = w.to(torch.float32)
    wk = (w32 * (1.0 / n)).reshape(Bh, A, Bl).contiguous()
    wk.view(-1)[:1].zero_()       # DC weight: its exact term is added below
    quad = quad_partials(x2, wk, n, m).sum(-1)
    quad = quad + w32[0] * float(n) * m * m
    return quad.reshape(lead)
