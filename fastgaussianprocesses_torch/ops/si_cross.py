r"""The lattice's shift-invariant cross-kernel on the card: the CUDA kernel
K5, its plain PyTorch version and its launch counter.

:func:`si_cross` computes, for rows ``x`` (R, d) against columns ``z``
(M, d), a batch of B hyperparameter rows (``s`` (B,), ``ls`` (B, d), task
factors ``f`` (B,) or None) and the derivative pairs ``p = (i0, i1)`` of
``beta0`` (p0, d) and ``beta1`` (p1, d)::

    out[b, r, c] = s_b f_b sum_p c0[i0] c1[i1] prod_j (ind_pj + ls_bj coeff_pj B_m((x_rj - z_cj) mod 1))

with ``m = 2 alpha_j - beta0[i0, j] - beta1[i1, j]`` and ``coeff``, ``ind``
as in ``kernels/series`` (``ops/bernoulli.si_coeff``, the indicator ``beta0 + beta1 ==
0``): ``kernel_fused_scan``'s Bernoulli series at the outer layout
``x (R, 1, d)`` against ``z (1, M, d)``, stored once.  With ``paired=True``
it is the diagonal ``out[b, r]`` of ``x`` (R, d) against ``z`` (R, d).

* **K5** (``csrc/si_cross.cu``) replaces no Pallas kernel: the JAX package
  leaves ``kernel_fused_scan``'s ``lax.scan`` to XLA, which fuses it into one
  pass.  The source's head comment has its bound and design.
* :func:`si_cross_plain` -- the same arithmetic in plain PyTorch, on any
  device: the series folded into one polynomial a (pair, dimension) with the
  lengthscale and the indicator in its coefficients, Horner's rule on
  ``|x - z|`` for x and z wrapped into [0, 1], the sign flipped for an odd
  degree where ``x < z``.  The wrapper runs it for CPU tensors only.

The fold rounds otherwise than the loop of ``kernel_fused_scan`` (which
evaluates ``B_m`` at ``(x - z) mod 1`` and multiplies the coefficient, the
lengthscale and the indicator in afterwards), so the two agree to rounding
relative to the largest kernel value, not elementwise where a factor passes
through zero.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib
from .bernoulli import _BERNOULLI_COEFFS, si_coeff

# launches of K5 since the last reset, by layout (the CPU plain version does not count)
launches = {"si_cross": 0, "si_pair": 0}

MAX_BATCH = 65535     # CUDA's limit on gridDim.y, which carries the batch row


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Table(NamedTuple):
    """The series folded for the kernel: ``tab`` (P, d, deg + 3), each (pair,
    dimension)'s ``coeff * B_m`` coefficients highest power first,
    zero-padded to the even degree ``deg`` that covers every m, then the
    indicator and the parity of m; ``w`` (P,) the pair weights; ``odd`` the
    parities again, on the host."""
    tab: torch.Tensor
    w: torch.Tensor
    deg: int
    odd: tuple


def _fold(alpha, beta0, beta1, c0, c1):
    """:class:`Table`'s arrays in float64 numpy."""
    d = len(alpha)
    P = len(beta0) * len(beta1)
    orders = [[2 * int(alpha[j]) - int(b0[j]) - int(b1[j]) for j in range(d)]
              for b0 in beta0 for b1 in beta1]
    deg = max(max(o) for o in orders)
    deg += deg % 2
    tab = np.zeros((P, d, deg + 3))
    w = np.empty(P)
    p = 0
    for i0, b0 in enumerate(beta0):
        for i1, b1 in enumerate(beta1):
            for j in range(d):
                m = orders[p][j]
                tab[p, j, deg - m:deg + 1] = si_coeff(int(alpha[j]), int(b0[j]), int(b1[j])) * (
                    np.asarray(_BERNOULLI_COEFFS[m]))
                tab[p, j, deg + 1] = 1.0 if b0[j] + b1[j] == 0 else 0.0
                tab[p, j, deg + 2] = m % 2
            w[p] = c0[i0] * c1[i1]
            p += 1
    return tab, w, deg


_TABLES = {}          # the tables in use, by their orders, weights, dtype and device
_MAX_TABLES = 64


def table(alpha, beta0, beta1, c0, c1, dtype, device) -> Table:
    """The :class:`Table` of the orders ``alpha`` (d,), ``beta0`` (p0, d),
    ``beta1`` (p1, d) and weights ``c0`` (p0,), ``c1`` (p1,) as ``dtype``
    tensors on ``device``, cached (a copy from the host each call would
    synchronise with the card; the key is the arrays' bytes, a few us a
    query chunk)."""
    beta0, beta1 = np.asarray(beta0, dtype=np.int64), np.asarray(beta1, dtype=np.int64)
    alpha = np.broadcast_to(np.asarray(alpha, dtype=np.int64), beta0.shape[-1:])
    c0, c1 = np.asarray(c0, dtype=np.float64), np.asarray(c1, dtype=np.float64)
    device = torch.device(device)
    key = (alpha.tobytes(), beta0.shape, beta0.tobytes(), beta1.shape, beta1.tobytes(),
           c0.tobytes(), c1.tobytes(), dtype, device)
    tb = _TABLES.get(key)
    if tb is None:
        tab, w, deg = _fold(alpha, beta0, beta1, c0, c1)
        tb = Table(torch.as_tensor(tab, dtype=dtype, device=device),
                   torch.as_tensor(w, dtype=dtype, device=device), deg,
                   tuple(tuple(bool(v) for v in row) for row in tab[..., deg + 2]))
        _TABLES[key] = tb
        while len(_TABLES) > _MAX_TABLES:
            _TABLES.pop(next(iter(_TABLES)))
    return tb


def _wrap(v):
    return v - torch.floor(v)


def si_cross_plain(x, z, tb: Table, s, ls, f=None, paired: bool = False):
    """K5's arithmetic in plain PyTorch (any device): ``x`` (R, d), ``z``
    (M, d) (paired: (R, d)), the :func:`table` ``tb``, ``s`` (B,), ``ls``
    (B, d), ``f`` (B,) or None -> (B, R, M) (paired: (B, R))."""
    tab, w, deg = tb.tab, tb.w, tb.deg
    xw, zw = _wrap(x), _wrap(z)
    P, d = tab.shape[:2]
    out = None
    for p in range(P):
        prod = None
        for j in range(d):
            dl = xw[:, j] - zw[:, j] if paired else xw[:, j, None] - zw[None, :, j]
            a = dl.abs()
            h = ls[:, j, None] * tab[p, j, :deg + 1]                       # (B, deg + 1)
            h[:, deg] += tab[p, j, deg + 1]
            hb = h.reshape(h.shape[:1] + (1,) * dl.dim() + h.shape[1:])
            v = hb[..., 0].expand((h.shape[0],) + tuple(dl.shape)).clone()
            for i in range(1, deg + 1):
                v = torch.addcmul(hb[..., i], v, a)
            if tb.odd[p][j]:
                v = torch.where(dl < 0, -v, v)
            prod = v if prod is None else prod * v
        out = w[p] * prod if out is None else torch.addcmul(out, w[p], prod)
    if f is not None:
        s = s * f
    return s.reshape((-1,) + (1,) * (out.dim() - 1)) * out


def _check(t, shape, dtype, device, what):
    if t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"si_cross {what}: need {dtype} on {device} of shape {tuple(shape)}, "
                         f"got {t.dtype} on {t.device} of shape {tuple(t.shape)}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"si_cross {what}: the kernel needs a contiguous tensor")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


class _Launch(torch.autograd.Function):
    """K5's launch inside an autograd Function, as K1, K2 and K4 launch: its
    forward is a host op that the profiler records, and a kernel launched
    through ctypes is linked only to the host op open at its launch (a
    ``record_function`` range is not one).  No backward: :func:`si_cross`
    refuses inputs that require grad."""

    @staticmethod
    def forward(ctx, x, z, s, ls, f, tb, paired):
        (R, d), M, B = x.shape, z.shape[0], s.shape[0]
        out = torch.empty((B, R) if paired else (B, R, M), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        lib = cuda_lib.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fgp_si_cross(_ptr(x), _ptr(z), _ptr(tb.tab), _ptr(tb.w), _ptr(ls), _ptr(s),
                                   ctypes.c_void_p(None if f is None else f.data_ptr()),
                                   _ptr(out), R, R if paired else M, d, tb.tab.shape[0], tb.deg,
                                   B, int(paired), int(x.dtype == torch.float64),
                                   ctypes.c_void_p(stream))
        cuda_lib.check(lib, err, "fgp_si_cross")
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("si_cross has no backward (query paths only)")


def si_cross(x, z, alpha, beta0, beta1, c0, c1, s, ls, f=None, paired: bool = False):
    """K5: the Bernoulli series cross-kernel (see the module docstring) of
    ``x`` (R, d) against ``z`` (M, d) -> (B, R, M), or with ``paired`` of
    ``x`` (R, d) against ``z`` (R, d) row with row -> (B, R); ``s`` (B,),
    ``ls`` (B, d) and ``f`` (B,) or None the batch's scales, lengthscales and
    task factors.  float32 or float64, one type and device for all.  CPU
    tensors take the plain version; CUDA tensors launch the kernel,
    contiguous, and raise on anything else.  Not differentiable: raises if an
    input requires grad."""
    ins = (x, z, s, ls) if f is None else (x, z, s, ls, f)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError("si_cross has no backward (query paths only)")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"si_cross: need float32 or float64 rows, got {x.dtype}")
    if x.dim() != 2 or z.dim() != 2:
        raise ValueError(f"si_cross: need (R, d) rows and (M, d) columns, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    (R, d), M, B = x.shape, z.shape[0], s.shape[0]
    dt, dev = x.dtype, x.device
    _check(x, (R, d), dt, dev, "rows")
    _check(z, (R if paired else M, d), dt, dev, "columns")
    _check(s, (B,), dt, dev, "scales")
    _check(ls, (B, d), dt, dev, "lengthscales")
    if f is not None:
        _check(f, (B,), dt, dev, "task factors")
    if np.asarray(beta0).shape[-1] != d or np.asarray(beta1).shape[-1] != d:
        raise ValueError("si_cross: derivative orders need one entry a dimension")
    tb = table(alpha, beta0, beta1, c0, c1, dt, dev)
    if dev.type == "cpu":
        return si_cross_plain(x, z, tb, s, ls, f, paired)
    if dev.type != "cuda":
        raise ValueError(f"si_cross: the kernel needs a CUDA tensor, got {dev}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"si_cross: the kernel takes 1 to {MAX_BATCH} batch rows, got {B}")
    out = _Launch.apply(x, z, s, ls, f, tb, paired)
    launches["si_pair" if paired else "si_cross"] += 1
    return out
