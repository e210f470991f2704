"""Orthonormal fast Walsh-Hadamard transform: the CUDA kernel K4, its plain
PyTorch version and a plain-PyTorch emulation of the kernel's algorithm
(counterpart of ``fastgaussianprocesses_tpu/ops/pallas_fwht.py`` and of the
contraction ``fwht`` in ``fastgaussianprocesses_tpu/ops/transforms.py``).

``fwht(x) = H_n x / sqrt(n)`` along the last axis, n a power of two, any
leading batch; H_n is the +/-1 Hadamard matrix in Sylvester order, so the
transform is symmetric, orthonormal and its own inverse.  ``fwht(x, mean)``
transforms ``x - mean[..., None]`` (the kernel subtracts as it loads).

* **K4** :func:`fwht` <- ``pallas_fwht._make_kernel`` (launched by
  ``_fwht_fused``).  ``csrc/fwht.cu`` runs the radix-2 butterflies, stage by
  stage from the lowest index bit up, 4 stages at a time on 16 values a
  thread in registers, with exchanges through padded shared memory between:
  pass 1 the 12 lowest index bits (all of them up to n = 2^14), each later
  pass up to 10 more bits on tiles of strided values down neighbouring
  columns.  One persistent launch: blocks take tiles from a ticket counter,
  groups of rows staggered so that pass 2 of a group reads pass 1's output
  back from L2, not from device memory.  :func:`fwht_plan` is the whole
  schedule (``fwht.cu``'s head comment has the bound and the design); it
  takes float32 and float64, every n and every number of rows.
* :func:`fwht_emulate` -- the kernel's algorithm in plain PyTorch: the
  plan's tiles in ticket order, with the kernel's index formulas for the
  loads, register steps, padded exchanges and stores.  Tests only.
* :func:`fwht_plain` -- the JAX package's contraction: the index split into
  factors of at most 8 bits, one ``tensordot`` with a +/-1 Hadamard block
  per factor.  The wrapper runs it for CPU tensors only.

The kernel and the emulation add in the order of a radix-2 butterfly network
(equal bit for bit to float32 numpy butterflies); the contraction sums in
another order, so float32 results differ by a few ulps of the largest
output (tests and ``chip_smoke.py`` state the tolerance).
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib
from .bitops import log2_int

# launches of K4 since the last reset (the CPU plain version does not count)
launches = {"fwht": 0}

LOG_FIRST = 12        # pass 1: the 12 lowest index bits (4096 contiguous values) ...
LOG_SINGLE = 14       # ... or all of them up to n = 2^14, a row a tile
LOG_LATER = 10        # each later pass: at most 10 more bits
# pass-1 output of one group of rows (bytes): what pass 2 reads back from the
# 50 MB L2; chosen on the H100 among 8, 12, 16 and 32 MB (PERF.md)
GROUP_BYTES = 12 << 20
THREADS_PER_SM = 2048


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


class FwhtPlan(NamedTuple):
    """K4's schedule for R rows of n = 2^log_n values (``fwht.cu`` derives
    the same passes, steps and ticket order from ``log_n``, ``log_tile``,
    ``LOG_FIRST``, ``LOG_LATER`` and ``group_rows``).

    A tile is 2^log_tile values, 16 a (virtual) thread; the kernel runs one
    or more virtual threads in each real thread.  A register layout ``(a, b)``
    puts register bits 0-1 at tile bits a, a+1 and register bits 2-3 at
    b, b+1, and the thread index in the other tile bits, lowest first
    (:func:`layout_index`); the window ``(w, w + 2)`` holds 4 contiguous bits.
    Register step ``(a, b, r0, r1)`` runs the stages of register bits
    r0..r1-1 in layout (a, b).  Pass 0 loads and stores in layout (0, 10),
    whose registers 0-3 are 4 contiguous values (16-byte vectors, neighbouring
    threads on neighbouring vectors): stages 0-1 there, 2-5 and 6-9 in
    windows, 10-11 back in (0, 10).  It maps tile index i of flat tile f to
    the flat offset ``f * 2^log_tile + i``.  A later pass with index bits
    [lo, lo + k) takes ``i = a * W + w`` (W = 2^(log_tile - k) columns) to
    ``hi * 2^(lo + k) + a * 2^lo + c + w`` with ``f * W = hi * 2^lo + c``,
    in windows over the a bits, loading in its first step's layout and
    storing in its last.

    One pass takes its tiles block by block (no tickets, no counters).
    Tickets (several passes): the groups' passes run staggered, slot s
    holding pass p of group s - p for p = 0, 1, ..., so a pass-p tile is
    dealt a whole group after the pass p-1 tiles it needs; it waits until
    every pass p-1 tile of its row is done (counter ``1 + (p-1) R + row``;
    counter 0 deals the tickets)."""
    log_n: int
    rows: int
    log_tile: int
    passes: tuple         # ((lo, k), ...): index bits [lo, lo + k) of each pass
    steps: tuple          # per pass: ((a, b, r0, r1), ...)
    tiles: int            # tiles of each pass
    tiles_per_row: int    # of each pass, when there are several passes (else 0)
    group_rows: int
    tickets: int
    grid: int
    counters: int


VEC = (0, 10)     # pass 0's load and store layout: registers 0-3 contiguous


def _first_pass_steps(log_tile: int, b1: int) -> tuple:
    """Pass 0's register steps over index bits [0, b1), b1 <= log_tile: bits
    0-1 and 10-11 in layout (0, 10), 2-5 and 6-9 in windows, 12-13 in the
    tile's top window."""
    out = [VEC + (0, min(2, b1))] if b1 else []
    for s in (2, 6):
        if s < min(b1, 10):
            out.append((s, s + 2, 0, min(4, min(b1, 10) - s)))
    if b1 > 10:
        out.append(VEC + (2, min(b1, 12) - 8))
    if b1 > 12:
        w = log_tile - 4
        out.append((w, w + 2, 12 - w, b1 - w))
    return tuple(out)


def _later_pass_steps(log_tile: int, k: int) -> tuple:
    """Register steps of a later pass over the tile's top k bits, 4 at a
    time in windows; a window never reaches past the tile's top bit."""
    out = []
    for s in range(0, k, 4):
        q = log_tile - k + s
        w = min(q, log_tile - 4)
        out.append((w, w + 2, q - w, q - w + min(4, k - s)))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def fwht_plan(n: int, rows: int, sms: int = 132, group_bytes: int = GROUP_BYTES,
              itemsize: int = 4) -> FwhtPlan:
    """K4's schedule for ``rows`` rows of length n on a card with ``sms``
    multiprocessors (see :class:`FwhtPlan`)."""
    m = log2_int(n)
    log_tile = 14 if m > 20 or m == LOG_SINGLE else 13
    passes = [(0, m if m <= LOG_SINGLE else LOG_FIRST)]
    while passes[-1][0] + passes[-1][1] < m:
        lo = passes[-1][0] + passes[-1][1]
        passes.append((lo, min(LOG_LATER, m - lo)))
    steps = (_first_pass_steps(log_tile, passes[0][1]),) + tuple(
        _later_pass_steps(log_tile, k) for _, k in passes[1:])
    if len(passes) == 1:
        tiles = -(-(rows << m) >> log_tile)
        tpr, group = 0, rows
    else:
        tpr = 1 << (m - log_tile)
        tiles, group = rows * tpr, max(1, min(rows, group_bytes // (n * itemsize)))
    tickets = len(passes) * tiles
    grid = min(tickets, sms * (THREADS_PER_SM >> (log_tile - 4)))
    counters = 1 + (len(passes) - 1) * rows if len(passes) > 1 else 0
    return FwhtPlan(m, rows, log_tile, tuple(passes), steps, tiles, tpr, group, tickets, grid,
                    counters)


def _slot_starts(plan: FwhtPlan) -> np.ndarray:
    """First ticket of each slot (several passes)."""
    P, G, tpr = len(plan.passes), plan.group_rows, plan.tiles_per_row
    groups = -(-plan.rows // G)
    s = np.arange(groups + P - 1)[:, None] - np.arange(P)[None, :]
    k = np.clip(s, 0, groups)           # groups of pass p dealt before slot s
    return np.minimum(k * G, plan.rows).sum(1) * tpr


def ticket_tiles(plan: FwhtPlan, tickets) -> tuple:
    """(pass, flat tile) of each ticket, as the kernel deals them."""
    t = np.asarray(tickets, dtype=np.int64)
    P = len(plan.passes)
    if P == 1:
        return np.zeros_like(t), t
    G, tpr = plan.group_rows, plan.tiles_per_row
    groups = -(-plan.rows // G)
    s = np.searchsorted(_slot_starts(plan), t, side="right") - 1
    u = t - _slot_starts(plan)[s]
    p = np.zeros_like(t)
    for q in range(P):                  # walk slot s's segments, pass 0 first
        g = s - q
        size = np.where((g >= 0) & (g < groups), (np.minimum((g + 1) * G, plan.rows) - g * G)
                        * tpr, 0)
        here = (p == q) & (u >= size)
        u = np.where(here, u - size, u)
        p = np.where(here, q + 1, p)
    return p, (s - p) * G * tpr + u


def layout_index(log_tile: int, a: int, b: int) -> np.ndarray:
    """(threads, 16) tile indices that the threads hold in layout (a, b)."""
    t = np.arange(1 << (log_tile - 4), dtype=np.int64)[:, None]
    q = np.arange(16)[None, :]
    base = ((t & ((1 << a) - 1)) | (((t >> a) & ((1 << (b - a - 2)) - 1)) << (a + 2))
            | ((t >> (b - 2)) << (b + 2)))
    return base | ((q & 3) << a) | ((q >> 2) << b)


def tile_offsets(plan: FwhtPlan, p: int, tiles, a: int, b: int) -> np.ndarray:
    """(len(tiles), threads, 16) flat offsets into the rows x n values that
    the threads of pass p's ``tiles`` hold in layout (a, b); -1 past the end
    (the ragged last tile of a one-pass plan)."""
    f = np.asarray(tiles, dtype=np.int64)[:, None, None]
    i = layout_index(plan.log_tile, a, b)[None]
    if p == 0:
        off = (f << plan.log_tile) + i
        return np.where(off < (plan.rows << plan.log_n), off, -1)
    lo, k = plan.passes[p]
    log_w = plan.log_tile - k
    col = f << log_w
    return (((col >> lo) << (lo + k)) + ((i >> log_w) << lo) + (col & ((1 << lo) - 1))
            + (i & ((1 << log_w) - 1)))


def _pad32(i):
    """Shared-memory slot of tile index i: one pad slot every 32."""
    return i + (i >> 5)


def _butterflies(v: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Stages r0..r1-1 of the radix-16 butterfly network on the last axis."""
    lead = v.shape[:-1]
    for h in range(r0, r1):
        y = v.reshape(lead + (16 >> (h + 1), 2, 1 << h))
        v = torch.stack((y[..., 0, :] + y[..., 1, :], y[..., 0, :] - y[..., 1, :]), -2)
        v = v.reshape(lead + (16,))
    return v


def _exchange(v: torch.Tensor, log_tile: int, src: tuple, dst: tuple) -> torch.Tensor:
    """Registers of layout src -> padded shared memory -> layout dst."""
    s = v.new_zeros((v.shape[0], _pad32(1 << log_tile)))
    s[:, torch.from_numpy(_pad32(layout_index(log_tile, *src))).reshape(-1)] = \
        v.reshape(v.shape[0], -1)
    return s[:, torch.from_numpy(_pad32(layout_index(log_tile, *dst)))]


def fwht_emulate(x: torch.Tensor, mean: torch.Tensor = None,
                 group_bytes: int = GROUP_BYTES) -> torch.Tensor:
    """K4's algorithm in plain PyTorch: :func:`fwht_plan`'s tiles in ticket
    order (consecutive tickets of one pass taken together: such tiles are
    independent), with the kernel's loads, steps, exchanges and stores."""
    n = x.shape[-1]
    rows = x.numel() // n
    plan = fwht_plan(n, rows, group_bytes=group_bytes, itemsize=x.element_size())
    src = x.reshape(-1)
    mu = None if mean is None else mean.reshape(-1).to(x.dtype)
    total = rows * n
    out = x.new_zeros(total + 1)               # the last slot takes masked stores
    scale = torch.tensor(1.0 / math.sqrt(n), dtype=x.dtype)
    p_of, f_of = ticket_tiles(plan, np.arange(plan.tickets))
    starts = np.flatnonzero(np.diff(p_of, prepend=-1))
    for lo, hi in zip(starts, list(starts[1:]) + [plan.tickets]):
        p, tiles = int(p_of[lo]), f_of[lo:hi]
        steps = plan.steps[p]
        lay = VEC if p == 0 else steps[0][:2]
        off = torch.from_numpy(tile_offsets(plan, p, tiles, *lay))
        if p == 0:
            v = torch.where(off >= 0, src[off.clamp(min=0)], 0)
            if mu is not None:
                v = v - mu[off.clamp(min=0) >> plan.log_n]
        else:
            v = out[off]
        for a, b, r0, r1 in steps:
            if (a, b) != lay:
                v, lay = _exchange(v, plan.log_tile, lay, (a, b)), (a, b)
            v = _butterflies(v, r0, r1)
        if p == 0 and lay != VEC:
            v, lay = _exchange(v, plan.log_tile, lay, VEC), VEC
        if p == len(plan.passes) - 1:
            v = v * scale
        off = torch.from_numpy(tile_offsets(plan, p, tiles, *lay))
        out[torch.where(off >= 0, off, total)] = v
    return out[:total].reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwht_cuda(x: torch.Tensor, mean: torch.Tensor = None, plan: FwhtPlan = None) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"fwht: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64) or not x.is_contiguous():
        raise ValueError(f"fwht: need a contiguous float32 or float64 tensor, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    n = x.shape[-1]
    rows = x.numel() // n
    if mean is not None and (mean.device != x.device or mean.dtype != x.dtype
                             or mean.shape != x.shape[:-1] or not mean.is_contiguous()):
        raise ValueError(f"fwht: mean must be a contiguous {x.dtype} tensor of shape "
                         f"{tuple(x.shape[:-1])} on {x.device}")
    if plan is None:
        plan = fwht_plan(n, rows, _sm_count(x.device.index if x.device.index is not None
                                            else torch.cuda.current_device()),
                         itemsize=x.element_size())
    out = torch.empty_like(x)
    lib = cuda_lib.load()
    with torch.cuda.device(x.device):
        # zeroed by the entry point on the stream (cudaMemsetAsync), so graph
        # replays start from zero; one buffer a call keeps concurrent streams apart
        counters = torch.empty(plan.counters, dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fgp_fwht(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                           ctypes.c_void_p(None if mean is None else mean.data_ptr()),
                           ctypes.c_void_p(counters.data_ptr()), rows, plan.log_n,
                           plan.log_tile, LOG_FIRST, LOG_SINGLE, LOG_LATER, plan.group_rows,
                           plan.tickets, plan.grid, plan.counters, int(x.dtype == torch.float64),
                           ctypes.c_void_p(stream))
    cuda_lib.check(lib, err, "fgp_fwht")
    launches["fwht"] += 1
    return out


def _fwht_rows(x: torch.Tensor, mean: torch.Tensor = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return fwht_plain(x if mean is None else x - mean[..., None])
    return _fwht_cuda(x.contiguous(), None if mean is None else mean.contiguous())


class _Fwht(torch.autograd.Function):
    """K4.  ``H`` is symmetric and orthonormal, so the backward of
    ``y = H (x - mean 1)`` is ``grad_x = H g`` (one more K4 launch) and, as
    ``1^T H = sqrt(n) e_0^T``, ``grad_mean = -sqrt(n) g[..., 0]``."""

    @staticmethod
    def forward(ctx, x, mean):
        ctx.has_mean = mean is not None
        return _fwht_rows(x, mean)

    @staticmethod
    def backward(ctx, g):
        gx = fwht(g) if ctx.needs_input_grad[0] else None
        gm = None
        if ctx.has_mean and ctx.needs_input_grad[1]:
            gm = g[..., 0] * -math.sqrt(g.shape[-1])
        return gx, gm


def fwht(x: torch.Tensor, mean: torch.Tensor = None) -> torch.Tensor:
    """K4: orthonormal FWHT of the last axis (length a power of two) of
    ``x``, or of ``x - mean[..., None]`` (``mean`` of shape ``x.shape[:-1]``).
    CPU tensors take the plain version; any other tensor launches the kernel
    or raises.  Differentiable in ``x`` and ``mean`` (the backward is K4)."""
    n = x.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"fwht: the last axis must have a power-of-two length, got {n}")
    return _Fwht.apply(x, mean)
