r"""Permuted-spectrum FFT on float32 planes: the CUDA kernels K1-K3 and their
plain PyTorch versions (counterpart of ``fastgaussianprocesses_tpu/ops/pallas_fft.py``).

Factorization, tables and output bin order are the JAX package's, copied
exactly (``_plan``, ``_tables``, ``spectrum_perm``), so spectra agree bin for
bin and the solver state can be compared directly::

    n = A * B,  B = Bh * Bl,   j = a*B + bh*Bl + bl,   k = k1 + A*kh + A*Bh*kl

    pass A : Y[k1, b]       = sum_a F_A[k1, a] x[a, b]          (torch.matmul)
    pass B : tw w_n^{k1 b}, DFT over bh, tw w_B^{kh bl}, DFT over bl  (kernel)

The spectrum comes back as ``(Bh, A, Bl)``: ``X_p.reshape(Bh, A, Bl)[kh, k1,
kl] == X[k1 + A*kh + A*Bh*kl]``, a fixed permutation with DC at index 0.

Kernels (``csrc/perm_fft.cu``; each wrapper launches it for CUDA tensors,
runs its plain version for CPU tensors, and raises for anything else):

* **K1** :func:`passb` <- ``pallas_fft._passb_kernel`` (pass B of ``pfft``).
  Per (row, k1): gather the (Bh, Bl) slab into shared memory, radix-2 DFTs
  down bh and along bl, write the permuted spectrum.  Bound on the H100 by
  bytes: 16 MB moved per n = 2^20 row (~5 us at 3.35 TB/s) against ~92
  MFLOP of butterflies (~1.4 us at 67 TFLOP/s).  The slab is contiguous in
  the k1-major pass-A output, so reads and writes are 512-byte runs.
* **K2** :func:`passb_inv` <- ``pallas_fft._passb_inv_kernel`` (pass B of
  ``pifft`` run backwards with the conjugate tables); the same bound.  It
  writes k1-major so the inverse pass A (with 1/n) is a plain matmul.
* **K3** :func:`quad_partials` <- ``pallas_fft._quad_kernel`` (``pfft_quad``):
  pass A, pass B and ``sum w |Z|^2`` fused; the spectrum never reaches device
  memory.  The function is bound on the H100 by the single 4 MB read of an
  n = 2^20 row (~1.3 us; a real FFT of the row is ~2.5*n*log2(n) FLOP,
  ~0.8 us).  This kernel does more work than that: pass A runs inside it
  as a direct length-A DFT per k1 (4*A*n FLOP a row, ~4 us at A = 64), and
  the A blocks of a row re-read it from L2.  It writes one partial sum per
  (row, k1), reduced in a fixed order; ``torch.sum`` over k1 follows, so
  the result is deterministic (no atomics).

Inputs are float32; pass A and its inverse are ``torch.matmul`` on float32
planes at full precision (TF32 is off, see ``config``), as the JAX package
leaves them to XLA.
"""

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib
from .bitops import log2_int

_MIN_M = 14           # below this torch.fft is used (half-spectrum solver)
_MAX_M = 22

# launches of each kernel since the last reset (the CPU plain versions do not count)
launches = {"passb": 0, "passb_inv": 0, "quad": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supported(n: int) -> bool:
    return n == (n & -n) and _MIN_M <= log2_int(n) <= _MAX_M


@functools.lru_cache(maxsize=None)
def _plan(n: int):
    """(A, Bh, Bl, K1B) exactly as the JAX package plans them (K1B is the
    TPU kernel's k1 block and unused here: a CUDA block holds one k1)."""
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
def _tables(n: int, inverse: bool):
    """Host-side DFT/twiddle tables: built in float64, stored as float32
    (re, im) numpy pairs."""
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


def _twiddle_row(F) -> np.ndarray:
    """Radix-2 twiddles w_L^k (k < L/2) as interleaved float32 pairs: row 1 of
    the float32 DFT table (one dummy pair when L == 1)."""
    L = F[0].shape[0]
    if L == 1:
        return np.zeros((1, 2), np.float32)
    return np.ascontiguousarray(np.stack([F[0][1, :L // 2], F[1][1, :L // 2]], -1))


@functools.lru_cache(maxsize=32)
def _dev_tables(n: int, inverse: bool, device: torch.device) -> dict:
    t = _tables(n, inverse)
    out = {}
    for k, (re, im) in t.items():
        out[k] = (torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))
    out["twh"] = torch.from_numpy(_twiddle_row(t["FBh"])).to(device)
    out["twl"] = torch.from_numpy(_twiddle_row(t["FBl"])).to(device)
    return out


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


# ---------------------------------------------------------------------------
# plain PyTorch versions (same factorization and tables; any device)
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


def passb_plain(Yr, Yi, n: int):
    """Plain K1: (R, A, B) k1-major pass-A planes -> (R, n) permuted spectrum."""
    A, Bh, Bl, _ = _plan(n)
    R = Yr.shape[0]
    t = _dev_tables(n, False, Yr.device)
    yr, yi = _twiddle1(Yr.reshape(R, A, Bh, Bl), Yi.reshape(R, A, Bh, Bl), t)
    outr, outi = _passb_stages(yr, yi, t)
    return (outr.permute(0, 2, 1, 3).reshape(R, n),
            outi.permute(0, 2, 1, 3).reshape(R, n))


def passb_inv_plain(Xr, Xi, n: int):
    """Plain K2: (R, n) permuted spectrum -> (R, A, B) k1-major pre-pass-A
    planes (inverse tables; no 1/n)."""
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


def _table_ptrs(t):
    return [_ptr(x) for k in ("T1", "T2", "T3") for x in t[k]] + [_ptr(t["twh"]), _ptr(t["twl"])]


def _passb_cuda(inr, ini, n: int, inverse: bool):
    A, Bh, Bl, _ = _plan(n)
    R = inr.shape[0]
    shape = (R, n)
    _check(inr, shape, "passb input (re)")
    _check(ini, shape, "passb input (im)")
    if ini.device != inr.device:
        raise ValueError("passb: planes on different devices")
    lib = cuda_lib.load()
    t = _dev_tables(n, inverse, inr.device)
    outr, outi = torch.empty_like(inr), torch.empty_like(ini)
    with torch.cuda.device(inr.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fgp_passb(_ptr(inr), _ptr(ini), _ptr(outr), _ptr(outi), *_table_ptrs(t),
                            R, A, log2_int(Bh), log2_int(Bl), int(inverse),
                            ctypes.c_void_p(stream))
    cuda_lib.check(lib, err, "fgp_passb")
    launches["passb_inv" if inverse else "passb"] += 1
    return outr, outi


def passb(Yr, Yi, n: int):
    """K1: (R, A, B) k1-major pass-A planes, flattened to (R, n) -> (R, n)
    permuted-spectrum planes."""
    if Yr.device.type == "cpu":
        return passb_plain(Yr, Yi, n)
    return _passb_cuda(Yr, Yi, n, inverse=False)


def passb_inv(Xr, Xi, n: int):
    """K2: (R, n) permuted-spectrum planes -> (R, n) k1-major pre-pass-A planes."""
    if Xr.device.type == "cpu":
        Yr, Yi = passb_inv_plain(Xr, Xi, n)
        return Yr.reshape(-1, n), Yi.reshape(-1, n)
    return _passb_cuda(Xr, Xi, n, inverse=True)


def quad_partials(xm, wk, n: int):
    """K3: mean-centred (R, n) float32 rows and (Bh, A, Bl) weights -> (R, A)
    per-k1 partial sums of ``wk * |pfft(xm)|^2``."""
    if xm.device.type == "cpu":
        return quad_plain(xm, wk, n)
    A, Bh, Bl, _ = _plan(n)
    R = xm.shape[0]
    _check(xm, (R, n), "quad rows")
    _check(wk, (Bh, A, Bl), "quad weights")
    if xm.data_ptr() % 16:
        raise ValueError("quad rows must be 16-byte aligned (float4 loads)")
    lib = cuda_lib.load()
    t = _dev_tables(n, False, xm.device)
    partial = torch.empty((R, A), dtype=torch.float32, device=xm.device)
    with torch.cuda.device(xm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fgp_quad(_ptr(xm), _ptr(t["FA"][0]), _ptr(t["FA"][1]), *_table_ptrs(t),
                           _ptr(wk), _ptr(partial), R, A, log2_int(Bh), log2_int(Bl),
                           ctypes.c_void_p(stream))
    cuda_lib.check(lib, err, "fgp_quad")
    launches["quad"] += 1
    return partial


# ---------------------------------------------------------------------------
# public ops (complex in/out; float32 planes inside)
# ---------------------------------------------------------------------------

def _flatten_batch(x, n):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, n), lead


def _pass_a(xr, xi, n: int):
    """Natural (R, n) planes -> (R, A, B) k1-major planes: Y = F_A @ x."""
    A = _plan(n)[0]
    FAr, FAi = _dev_tables(n, False, xr.device)["FA"]
    x3r = xr.reshape(-1, A, n // A)
    if xi is None:
        return FAr @ x3r, FAi @ x3r
    x3i = xi.reshape(-1, A, n // A)
    return FAr @ x3r - FAi @ x3i, FAi @ x3r + FAr @ x3i


def pfft(x, n: int):
    """Unnormalized DFT of the last axis in PERMUTED spectrum order
    (``spectrum_perm``).  ``x`` real or complex; returns complex64."""
    x2, lead = _flatten_batch(x, n)
    if x2.is_complex():
        xr = x2.real.to(torch.float32).contiguous()
        xi = x2.imag.to(torch.float32).contiguous()
    else:
        xr, xi = x2.to(torch.float32).contiguous(), None
    Yr, Yi = _pass_a(xr, xi, n)
    R = xr.shape[0]
    outr, outi = passb(Yr.reshape(R, n), Yi.reshape(R, n), n)
    return torch.complex(outr, outi).reshape(lead + (n,))


def pifft_real(X, n: int):
    """Real part of the inverse of :func:`pfft` (includes 1/n): permuted
    spectrum in, natural order out, without forming the imaginary plane."""
    X2, lead = _flatten_batch(X, n)
    Xr = X2.real.to(torch.float32).contiguous()
    Xi = X2.imag.to(torch.float32).contiguous()
    Yr, Yi = passb_inv(Xr, Xi, n)
    A = _plan(n)[0]
    FAr, FAi = _dev_tables(n, True, X2.device)["FA"]
    R = Xr.shape[0]
    Y3r, Y3i = Yr.reshape(R, A, n // A), Yi.reshape(R, A, n // A)
    xr = (FAr * (1.0 / n)) @ Y3r - (FAi * (1.0 / n)) @ Y3i
    return xr.reshape(lead + (n,))


def pfft_quad(x, w, n: int):
    """``sum_b w_b * |pfft_stable(x)_b|^2`` per row, fused in K3.

    ``w``: real (n,) weights in permuted bin order; the 1/n orthonormal
    normalization is folded in.  The mean-centring and the exact stabilized
    DC term ``w_0 * n * mean^2`` are done here, around the kernel, as in the
    JAX package.  Not differentiable (query paths only)."""
    A, Bh, Bl, _ = _plan(n)
    x2, lead = _flatten_batch(x, n)
    x2 = x2.to(torch.float32)
    m = x2.mean(-1)
    xm = (x2 - m[:, None]).contiguous()
    w32 = w.to(torch.float32)
    wk = (w32 * (1.0 / n)).reshape(Bh, A, Bl).contiguous()
    wk.view(-1)[:1].zero_()       # DC weight: its exact term is added below
    quad = quad_partials(xm, wk, n).sum(-1)
    quad = quad + w32[0] * float(n) * m * m
    return quad.reshape(lead)
