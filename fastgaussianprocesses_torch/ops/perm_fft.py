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
  ``sum w |Z|^2`` over the spectrum of mean-centred real rows (centred as
  pass A loads them when given the row means), the spectrum never written
  whole.  The function is bound on the H100 by the single
  4 MB read of an n = 2^20 row (~1.3 us; a real FFT of the row is
  ~2.5*n*log2(n) FLOP, ~0.8 us).  A call is two launches on K3's own
  split n = A*B (:func:`_quad_plan`: 256 x 2^12 at n = 2^20, so a slab is
  32 KB): pass A as a length-A FFT, writing only the slabs k1 = 0..A/2
  (for real rows slab A - k1 is the conjugate mirror of slab k1), then one
  block per (row, k1 <= A/2) slab for the length-B DFT as Stockham
  radix-16 passes and the sum with the folded weights of
  :func:`fold_weights`.  The half spectrum (R, A/2+1, B) is scratch: at
  n = 2^20 the call moves ~3x the fused bound.  One
  partial sum per (row, k1 <= A/2), reduced in a fixed order; ``torch.sum``
  over them follows, so the result is deterministic (no atomics).
  :func:`quad_emulate` is the same two-phase algorithm in plain PyTorch.

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
def _quad_plan(n: int):
    """K3's own split n = A * B: A in {64, 128, 256}, with B = n / A at most
    2^12 where A = 256 allows it (2^13 and 2^14 at n = 2^21 and 2^22), so
    that a slab (32 KB at B = 2^12) leaves room for several blocks an SM and
    its FFT takes three radix-16 passes.  Returns (A, B)."""
    A = min(256, max(_plan(n)[0], n >> 12))
    return A, n // A


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


def _pairs(ph):
    """Interleaved float32 (re, im) pairs of exp(i*ph), ph in float64."""
    return np.ascontiguousarray(np.stack([np.cos(ph), np.sin(ph)], -1), dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _dev_tables(n: int, inverse: bool, device: torch.device) -> dict:
    t = _tables(n, inverse)
    out = {}
    for k, (re, im) in t.items():
        out[k] = (torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))
    out["twh"] = torch.from_numpy(_twiddle_row(t["FBh"])).to(device)
    out["twl"] = torch.from_numpy(_twiddle_row(t["FBl"])).to(device)
    if not inverse:
        # K3 on its own split (A, B), B = Bh * Bl with Bl = 128: w_A^j (j < A);
        # w_B^j (j < Bl), then w_B^{Bl j} (j < Bh); tw 1 w_n^{k1 b} for
        # k1 <= A/2 as w_n^{k1 Bl bh} (A/2+1, Bh) and w_n^{k1 bl} (A/2+1, Bl)
        A, B = _quad_plan(n)
        Bl = 128
        Bh = B // Bl
        k1 = np.arange(A // 2 + 1, dtype=np.float64)[:, None]
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


@functools.lru_cache(maxsize=None)
def _fold_index(n: int):
    """Indices into the flat permuted weights for K3's folded weights, on its
    split (A, B) = ``_quad_plan(n)``: ``idx`` (A/2+1, B) of bin k = k1 + A*k2,
    and ``mirror`` (A/2-1, B) of bin n - k for the slabs 1 <= k1 < A/2, whose
    conjugate mirror slab A - k1 is not computed (slabs 0 and A/2 hold both
    bins of every pair)."""
    A = _quad_plan(n)[0]
    inv = np.argsort(spectrum_perm(n))          # inv[k]: permuted position of bin k
    k = np.arange(A // 2 + 1)[:, None] + A * np.arange(n // A)[None, :]
    return inv[k], inv[n - k[1:A // 2]]


@functools.lru_cache(maxsize=32)
def _dev_fold_index(n: int, device: torch.device):
    return tuple(torch.from_numpy(i.reshape(-1)).to(device) for i in _fold_index(n))


def fold_weights(wk, n: int):
    """(Bh, A, Bl) permuted weights -> (A/2+1, B) folded weights ``w'[k1, k2]``
    of bin k = k1 + A*k2: ``w_k + w_{n-k}`` for 1 <= k1 < A/2, ``w_k`` for
    k1 = 0 and A/2.  For a real row, ``sum_k w_k |X_k|^2 ==
    sum_{k1 <= A/2, k2} w'[k1, k2] |X_{k1 + A k2}|^2``.  A zeroed DC weight
    stays zero: bin 0 lies in slab 0, which is not folded.  (A, B) is
    ``_quad_plan(n)``."""
    A = _quad_plan(n)[0]
    idx, mirror = _dev_fold_index(n, wk.device)
    flat = wk.reshape(-1)
    wf = flat.index_select(0, idx).reshape(A // 2 + 1, n // A)
    wf[1:A // 2] += flat.index_select(0, mirror).reshape(A // 2 - 1, n // A)
    return wf


def _dft_mat(m: int, dtype):
    j = np.arange(m)
    ph = (-2 * np.pi / m) * np.outer(j, j)
    return torch.complex(torch.from_numpy(np.cos(ph)), torch.from_numpy(np.sin(ph))).to(dtype)


def _expi(ph, dtype):
    return torch.complex(torch.cos(ph), torch.sin(ph)).to(dtype)


def quad_half_pass_a(xm, n: int):
    """K3 phase 1 in plain PyTorch: real (R, n) rows -> (R, A/2+1, B) complex
    ``Y[k1, b] = sum_a x[a, b] w_A^{a k1}`` for k1 <= A/2, as the kernel
    factors it: (A, B) = ``_quad_plan(n)``, A = A1*A2, a = A2*a1 + a2,
    k1 = p + A1*q."""
    A = _quad_plan(n)[0]
    A1 = 8 if A == 64 else 16
    A2 = A // A1
    R, B = xm.shape[0], n // A
    cdt = torch.complex128 if xm.dtype == torch.float64 else torch.complex64
    x = xm.reshape(R, A1, A2, B).to(cdt)                                # [r, a1, a2, b]
    u = torch.einsum("ip,riab->rapb", _dft_mat(A1, cdt), x)            # [r, a2, p, b]
    a2p = torch.outer(torch.arange(A2), torch.arange(A1)).double()
    u = u * _expi((-2 * np.pi / A) * a2p, cdt)[None, :, :, None]
    y = torch.einsum("aq,rapb->rqpb", _dft_mat(A2, cdt), u)            # [r, q, p, b]
    return y.reshape(R, A, B)[:, :A // 2 + 1]


def quad_slab_sums(y, wf, n: int):
    """K3 phase 2 in plain PyTorch: (R, A/2+1, B) half pass-A output and
    (A/2+1, B) folded weights -> (R, A/2+1) per-slab sums
    ``sum_k2 wf[k1, k2] |DFT_B(w_n^{k1 b} Y[k1, b])[k2]|^2``, the DFT as the
    kernel's Stockham passes (radix 2^(log2 B mod 4) first, then 16s)."""
    A, B = _quad_plan(n)
    H = A // 2 + 1
    m = log2_int(B)
    cdt = y.dtype
    k1b = torch.outer(torch.arange(H), torch.arange(B)).double()
    z = y * _expi((-2 * np.pi / n) * k1b, cdt)                         # tw 1
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
    return torch.einsum("rkb,kb->rk", z.real ** 2 + z.imag ** 2, wf.to(z.real.dtype))


def quad_emulate(x, wk, n: int, mean):
    """K3's two-phase algorithm in plain PyTorch (any device, float32 or
    float64): (R, n) rows, centred by subtracting ``mean`` (R,), and
    (Bh, A, Bl) weights -> (R, A/2+1) per-slab partial sums, whose row sums
    equal those of :func:`quad_plain` on the centred rows."""
    return quad_slab_sums(quad_half_pass_a(x - mean[:, None], n), fold_weights(wk, n), n)


def quad_partials(x, wk, n: int, mean):
    """K3: (R, n) float32 rows ``x``, their (R,) means and (Bh, A, Bl)
    weights -> per-row partial sums of ``wk * |pfft(x - mean)|^2``: (R, A)
    per k1 of ``_plan(n)`` from the plain version for CPU tensors,
    (R, A/2+1) per half-spectrum slab of ``_quad_plan(n)`` from the two
    kernels for CUDA tensors.  The kernel centres a row as it loads it, so
    the caller writes no centred copy."""
    if x.device.type == "cpu":
        return quad_plain(x - mean[:, None], wk, n)
    R = x.shape[0]
    _check(x, (R, n), "quad rows")
    _check(mean, (R,), "quad row means")
    A0, Bh, Bl, _ = _plan(n)
    _check(wk, (Bh, A0, Bl), "quad weights")
    A, B = _quad_plan(n)
    lib = cuda_lib.load()
    t = _dev_tables(n, False, x.device)
    wf = fold_weights(wk, n)
    H = A // 2 + 1
    y = torch.empty((R, H, B, 2), dtype=torch.float32, device=x.device)
    partial = torch.empty((R, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fgp_quad(*[_ptr(v) for v in (x, mean, t["twa"], t["qt1"], t["qt2"],
                                                 t["qtw"], wf, y, partial)],
                           R, A, log2_int(B), ctypes.c_void_p(stream))
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
    """``sum_b w_b * |pfft_stable(x)_b|^2`` per row, through K3.

    ``w``: real (n,) weights in permuted bin order; the 1/n orthonormal
    normalization is folded in.  The stabilization is the JAX package's:
    the row mean is taken here and subtracted from the row (by the kernel as
    it loads the row), and the exact DC term ``w_0 * n * mean^2`` is added
    here.  Not differentiable (query paths only)."""
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
