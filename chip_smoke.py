#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastgaussianprocesses_torch``) on one
NVIDIA GPU, written for an H100.  Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and the exit code is not 0:

1. The card's name and power limit; build ``csrc/perm_fft.cu`` and
   ``csrc/fwht.cu`` with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source,
   started together), then the host lattice library
   ``points/_native/fastgp_native.cpp`` with ``g++``.
2. The slices: ``FastGPLattice(d=8, seed_for_seq=7, alpha=2)``, then
   ``FastGPDigitalNetB2(d=8, seed_for_seq=7, alpha=2)``, each in float32 on
   the card, n = 2^20 points, hyperparameters from a seed loaded through
   ``load_jax_params``; requests: 3 x ``post_mean_var`` on 4096 points, then
   ``post_mean``, ``post_var``, ``post_cubature_mean``, ``post_cubature_var``.
   Kernel launch counters are zeroed just before each model's run and read
   just after; every kernel of its path must have launched (K1-K3 and K5,
   the cross-kernel and the prior diagonal, for the lattice, K4 for the
   digital net), and the lattice's first ``post_mean_var`` must launch K5
   exactly once a query chunk in each layout.  They run first, so that the lattice's
   first request pays what a fresh serving process pays.  One more
   ``post_mean_var`` of each runs under ``torch.profiler`` for the
   device-time split; the digital net's must subtract no row means from a
   whole query chunk (K4 centres the rows as it loads them).
3. Kernels K1-K3 (``ops/perm_fft``, each two launches a call): K1 and K2
   are the whole ops ``pfft`` (real and complex rows) and ``pifft_real``,
   held against their plain PyTorch versions at every split the kernels
   take (``K12_CASES``: n = 2^14..2^22, R = 1, 2, 3 and 59), with ``pfft``
   against float64 numpy and the round trip.  K3 (pass A, then the
   half-spectrum slabs) against its plain version at n = 2^14, 2^15, 2^17,
   2^20 (R = 1, 25, 59) and 2^22, and ``pfft_quad`` against float64 numpy.
   At n = 2^14 and the main path's shapes (n = 2^20 with R = 1 and 59):
   times of the op, the plain version and one library yardstick
   (``torch.fft``) on the same inputs, each a CUDA graph of repeated calls
   replayed between CUDA events, beside the bound: the least time for the
   function's work (its inputs read and outputs written once, or the FLOPs
   of the best FFT algorithm, whichever takes longer).  K1/K2's "kernel"
   time is the device time of their two launches (``torch.profiler``), the
   "whole op" time the graph's time a call.  For K3 a second yardstick is
   logged: ``torch.fft.rfft`` with the weights of each conjugate pair
   summed, the strongest single-call form.
   K2 with complex output (``pifft``; ``check_k12``, ``phase_pifft``): against its plain
   version at every ``K12_CASES`` split on the spectra of real and complex
   rows, the round trip ``pifft(pfft(z))``, and ``pfft``'s backward on
   complex rows (``n * pifft(g)``) against autograd through ``torch.fft``;
   at n = 2^20, R = 1 its times, bound and library yardstick
   (``torch.fft.ifft`` after the gather), as for K1/K2; then its path,
   ``transforms.pifft_ortho`` and that backward with the counters reset
   just before and read just after (two launches).
   Kernel K4 (``ops/fwht``) the same way at n = 2^14, R = 3 and at the
   shapes of the digital-net path (n = 2^20 with R = 1 and the query chunk,
   R = 119; n = 2^22, R = 1), and against float64 and float32 numpy
   butterfly networks (also centring the rows as it loads them); no
   PyTorch call computes a Walsh-Hadamard transform, so K4 has no library
   yardstick.  At R = 1 also "cold": calls cycling through inputs larger
   than the 50 MB L2, as the serving path finds its input; at R = 119 also
   the whole op ``ft_stable_fwht``, K4's group sizes 8, 12, 16 and 32 MB,
   and the rate at which K4 moves the function's bytes.
   Kernel K5 (``ops/si_cross``, ``si_cross_times``) at the lattice's query
   chunk, R = 59 rows against n = 2^20 columns, d = 8, alpha = 2: against
   its plain version, timed beside it, the whole ``kernel_fused_scan``
   through it, the loop it replaced, and the bound; and its paired layout
   (the prior diagonal of the chunk).
4. Cross-checks at n = 2^16, d = 8: the card's float32 paths against the
   CPU's float32 plain-kernel paths and the CPU's float64 paths (lattice:
   half spectrum; digital net: the general solver).
5. The fit step, ``bench.py``'s configuration: ``fit(iterations=20)`` of
   each model at n = 2^20, d = 8, float32 on the card, with the plain
   versions of K1, K2 and K4 made to raise and the launch counters reset
   just before and read just after (the lattice's MLL must launch K1 and,
   as its backward, K2 every step; a short CV fit K2 and, as its backward,
   K1; the digital net K4 twice a step); the loss finite and every trained
   parameter moved.  The step (loss, gradient, Rprop update) timed as
   ``bench.py:bench_fit_steps`` times it (wall time a step of chains of 64,
   best of 3, at ``steps_per_dispatch`` 1 and 32), profiled (device busy
   share, launches, the kernels' share, the series contraction forward and
   backward against autograd through its loop), and its peak memory.  The
   MLL and its gradient at n = 2^16, noise 1.0, on the card against the
   CPU in float32 (plain kernels) and float64.  Each backward alone on the
   card against autograd through ``torch.fft`` (K1/K2) or the CPU plain
   version (K4, float64 and float32) at n = 2^14, 2^20, 2^22 and R = 1, 3,
   with device times at n = 2^20, R = 1.  The fused fit,
   ``fit(iterations=20, verbose=0, steps_per_dispatch=-1)`` of each model
   with the plain versions refused, against K = 32 from the same start: the
   same iterations, raw parameters within rtol 1e-6 (and whether bit for
   bit), its launch counters (reset just before, the fit's caches warm)
   grown by exactly the per-step launches times the 21 steps its one block
   computes; its step timed beside K = 1 and 32 (chains of 64 steps at
   K = 64, the loop that -1 runs); the host synchronisations of one block
   of 64 steps counted under ``torch.cuda.set_sync_debug_mode``: one, its
   fetch.  One ``{"fit_step": ...}`` line, which holds the fused fit's
   launch counts.
6. Multitask, derivative-informed and fleet models, float32 on the card,
   hyperparameters from a seed, the plain versions of K1, K2 and K4 made to
   raise; each fit and the requests with the launch counters reset just
   before and read just after, each call's wall time, the fit step's and
   the first request's device busy share (``torch.profiler``) and launches,
   peak memory:

   * ``mt_dnb2``: ``FastGPDigitalNetB2(d=8, num_tasks=3)``, multi-fidelity
     n = (2^20, 2^19, 2^18) (``examples/multitask.py``'s 4n, 2n, n; M = 7,
     the Schur ladder), y_l = f + 0.1 l cos(2 pi x_2); ``fit(iterations=20)``,
     ``post_mean_var`` of 1024 points for every task, ``post_cov`` of 256 x
     256 points for every task pair, ``post_ci`` of 256 points for task 2,
     ``post_cubature_cov()``: K4 in the fit and in serving;
   * ``mt_lattice``: the same on ``FastGPLattice`` (``torch.fft``; no
     ``post_cov``);
   * ``deriv_dnb2``: ``bench.py:make_lattice_grad`` on the digital net, d = 3,
     alpha = 3, (f, grad f) as 4 tasks at n = 2^16 each (M = 4), in float64
     (float32 resolves it in neither package; see ``deriv_model``):
     ``fit(iterations=20)``, ``post_mean`` of 1024 points for every task;
   * ``fleet_lattice``: ``FastGPLattice(d=8, shape_batch=(8,))`` with its own
     lengthscales and scale a member, n = 2^16, y_b = (b + 1) f:
     ``fit(iterations=10)``, ``fit(iterations=4, masks=...)`` over members 1
     and 5, ``post_mean_var`` of 4096 points: K1 (R = 8) and K2 as its
     backward in the fit, K3 a member (R = 953) in serving; its variances
     also timed through K1 and torch ops, the JAX package's route for a
     batched spectrum (``fleet_var_routes``).

   Then K1, K2 and K3 at n = 2^14 on 70 000 rows, past CUDA's gridDim.y cap
   (the public ops, both sides of the 65535-row boundary against the plain
   versions; then the kernels into NaN-filled outputs, every row written);
   and cross-checks at n = (2^12, 2^11, 2^10) (d = 8)
   and 2^12 (d = 3): the card's float32 against the CPU's float32 and
   float64 (for ``deriv_dnb2``, which float32 does not resolve, the card's
   float64 against the CPU's) on coefficients, log-determinant, MLL and its
   gradient's signs, ``post_mean_var``, ``post_cov`` and
   ``post_cubature_cov``; one ``{"multitask": ...}`` line.
7. The HMC hyperposterior (``fit/hmc.sample_gp_hyperposterior``: ChEES,
   dense mass, every chain a row of one solver), ``StandardGP`` and the
   examples, float32 on the card unless said otherwise, the plain versions
   of K1, K2 and K4 made to raise; each HMC cell with the launch counters
   reset just before and read just after, every gradient launching K1 and
   K2 once (lattice) or K4 twice (digital net), each on all 8 chains' rows,
   every log-density finite; samples/s as ``bench.py`` computes it
   (``num_samples * chains / wall``, warmup included), acceptance, step
   size, mean leapfrog count, worst R-hat, least ESS, gradient evaluations,
   and a profiled stretch of 6 iterations (device busy share, launches and
   device time a gradient):

   * ``hmc_lattice``: ``bench.py:bench_hmc``, ``FastGPLattice(d=4,
     seed_for_seq=7, alpha=2)`` at n = 2^14 (the permuted path: K1, K2 at
     R = 8), ``fit(iterations=30)``, 8 chains, 300 warmup, 50 samples;
   * ``hmc_flagship``: ``FastGPLattice(d=8)`` at n = 2^20, ``bench.py``'s
     y and hyperparameters, 8 chains, 20 warmup, 20 samples, at most 32
     leapfrog steps;
   * ``hmc_dnb2``: ``FastGPDigitalNetB2(d=4)`` at n = 2^14 (K4 at R = 8),
     8 chains, 50 warmup, 50 samples;
   * ``standard``: ``StandardGP(8, seed_for_seq=7)`` at n = 2^13 in float64
     and float32 (``fit(iterations=20)``, the step timed and profiled,
     ``post_mean_var`` of 4096 points, the cubature mean and variance,
     ``post_ci``, peak memory; float32 printed against float64), a
     derivative-informed model (d = 3, (f, grad f) as 4 tasks at 2^9) and one
     on ``Halton(8, seed=7)`` points at 2^12;
   * the examples ``simple``, ``multitask``, ``batch_multitask``,
     ``derivative_informed`` and ``hyperposterior`` at their default sizes;
   * host point generation at d = 8, n = 2^20 (best of 3): the lattice from
     the g++ library and from numpy (held bit for bit equal), and the
     digital net's numpy doubling;
   * cross-checks, last: the card's sampler against the CPU's on the same
     draws (lattice n = 2^8, d = 2, noise 1.0, float64, 4 chains, 10
     iterations; 1e-8),
     each of 8 chains' log-density and gradient at n = 2^14, d = 4 (card
     float32 against CPU float32 and float64), and ``StandardGP``'s float64
     on the card against the CPU's at n = 2^10, noise 1e-2 (1e-9).

   One ``{"hmc_standard_examples": ...}`` line.
8. The parallel layer (``fastgaussianprocesses_torch/parallel``) in one NCCL
   process group of world size 1, made in this process over a ``FileStore``,
   the plain versions of K1, K2 and K4 made to raise
   (``parallel/smoke.body``, whose docstring lists each check):
   ``make_sharded_fit_step`` on ``fleet_lattice``'s configuration and the
   same fleet on ``FastGPDigitalNetB2`` (n = 2^16, 8 members): the launch
   counters show K1 and K2 (or K4 twice) every step, on 8 rows; loss
   (rtol 1e-6) and raw parameters (atol 1e-6) equal the model's unsharded
   step; the step timed as ``bench.py:bench_fit_steps`` times it (chains of
   16, best of 3) and profiled.  ``use_sequence_sharding`` on the digital
   net flagship (n = 2^20): its MLL (rtol 1e-4) and gradient (1e-3 of the
   largest) equal the unsharded ones, K4 launched.  A chain-sharded
   ``hmc_lattice`` run (20 + 20 iterations) equals the unsharded run on the
   same seed (1e-5), one K1 and one K2 a gradient on 8 rows.  ``measure_collective_overhead`` at k = 1.  One
   ``{"parallel_one_card": ...}`` line.
9. The ``nvidia-smi`` line, the ``{"kernels": [...]}`` line (the serving
   kernels, K2 with complex output on its path, then K2, K1 and K4 as
   backwards in the fit, then phase 6's,
   phase 7's and phase 8's roles) and, last, ``{"ok": true, "device":
   {...}}``.

``python3 chip_smoke.py --multichip``, on a host with four cards, builds
the kernels and the host library in this process, then spawns one NCCL
rank a card
(``parallel/dryrun.SpawnedRanks``: a ``FileStore`` rendezvous, every
collective timed out after 300 s, the ranks killed after 1000 s), each
running ``parallel/smoke.body`` with the whole set: the fleet step against
the one-card step; the sequence-sharded MLL, GCV and CV loss and gradient
of both flagship models at n = 2^20 in float32 against the one-card
float32 values (rtol 1e-4 on the loss, 1e-3 of the largest gradient) and
at n = 2^16 in float64 against one card's float64 (1e-10, 1e-8); the
sharded transforms at n = 2^20 against one card's (1e-5 of the largest
output); the peak memory of a rank's MLL step at n = 2^20 and 2^22 beside
one card's; chain-sharded HMC of ``hmc_lattice`` and ``hmc_flagship`` (each
gradient K1 + K2 on 2 rows a rank, every log-density finite, the first 4
iterations against the one-card sampler on the same row blocks at 1e-5,
the whole run's acceptance within 0.25 and step size within 2x of the
one-card run's); ``measure_hmc_scaling`` and
``measure_collective_overhead`` at k = 1 and 4; ``dryrun_multichip(4)``;
then the three paths under a sequence mesh, each against rank 0's one-card
run (``parallel/smoke.TOL``): serving of both flagships (``post_mean_var``
of 4096 points, ``coeffs``, the cubature mean and variance; a steady
request timed on 4 cards and on 1, profiled on rank 0; a rank's peak
memory), mt_dnb2 (3 tasks at n = 2^20, 2^19, 2^18, M = 7: the MLL and its
gradient timed on 4 cards and 1, the all-to-alls a step counted;
``post_mean_var`` of 1024 points a task) and the hyperposterior of
``hmc_flagship``'s configuration on the lattice and the digital net (the
log-density and gradient of 8 chains, samples/s on 4 cards and 1, the
ranks' samples bit for bit equal), each model's hyperposterior again on the
2 x 2 mesh ``{"chains": 2, "seq": 2}`` (``chain_sharding`` over
``"chains"``: the digital net's K4 at least twice a gradient on (4, 2^19)
blocks, the start against the same one-card reference, the four ranks'
samples bit for bit equal), and the fleet step of both models on ``{"batch":
2, "seq": 2}``, the fleet sequence-sharded, against the one-card step and
timed beside the 1-D step.  Then, on card 0, K1-K4 at the shapes a
rank runs, those K4 met on the three paths included, through phase 3's own
checks and timings (``phase_kernels`` / ``phase_fwht`` with ``base=False``).  It prints one
``{"parallel": ...}`` line, the ``nvidia-smi`` line, a ``{"kernels":
[...]}`` line of those roles with the four-card launches and, last,
``{"ok": true, "device": {...}}`` with the count of cards used.

``python3 chip_smoke.py --fwht-times [DIR]`` times K4 alone as phase 3
does (public API only), for the package in DIR (default: this checkout),
and prints one ``{"fwht_times": ...}`` line: a way to time another
checkout (a parent commit) on the same card.  ``python3 chip_smoke.py
--si-cross-times`` runs phase 3's K5 part alone and prints one
``{"si_cross_times": ...}`` line.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# the CPU reference models of phase 4 take the float32 permuted path through
# the plain kernel versions; the card takes it regardless
os.environ["FASTGPS_TORCH_FORCE_PERM"] = "1"

PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_S = 67e12       # H100 SXM FP32 without tensor cores (FMA = 2 FLOP)
N_MAIN = 1 << 20
D = 8
N_QUERY = 4096
NB_DIGITAL = 119          # rows of the digital net's query chunk at n = 2^20
NB_LATTICE = 59           # rows of the lattice's query chunk at n = 2^20
TOL_K5 = 1e-5             # K5 against its plain version, f32: of the largest value
TOL_KERNEL = 3e-6         # max relative error against the plain version, f32
EPS32 = float(np.finfo(np.float32).eps)


def log(*a):
    print(*a, flush=True)


def smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def gtime(fn, iters):
    """Device ms per call: ``iters`` calls captured in one CUDA graph, replayed
    between CUDA events (no host launch overhead in the number)."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / iters)
    del g
    return best


def rel_err(got, want):
    """(max |got - want| / max |want|, max |got - want|), in float64 on the host."""
    dt = torch_complex_or_double(got, want)
    got, want = got.cpu().to(dt), want.cpu().to(dt)
    return float((got - want).abs().max() / want.abs().max()), float((got - want).abs().max())


def torch_complex_or_double(*ts):
    import torch
    return torch.complex128 if any(t.is_complex() for t in ts) else torch.float64


def fft_flops(n, R):
    """Least FLOPs of K1/K2's functions on real rows of length n, whatever
    the kernel does: a real-input FFT (2.5 n log2 n FLOP a row) for ``pfft``,
    and its transpose, a complex-to-real inverse, for ``pifft_real``."""
    return R * n * 2.5 * math.log2(n)


def quad_flops(n, R):
    """Least FLOPs of ``sum_b w_b |FFT(x)_b|^2`` (K3) over real rows of
    length n, whatever the kernel does: a real-input FFT (2.5 n log2 n FLOP)
    and, per conjugate bin pair, |Z|^2 times the summed weights (~6 FLOP)."""
    return R * n * (2.5 * math.log2(n) + 3)


def bound(nbytes, flops):
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# (n, R) at which K1/K2 are held against their plain versions: every split the kernels
# take (theirs differs from _plan's at 2^19, 2^20, 2^21), the main path's R = 1 and the
# query chunk's R = 59
K12_CASES = [(1 << 14, 3), (1 << 15, 2), (1 << 17, 3), (1 << 19, 1), (N_MAIN, 1), (N_MAIN, 59),
             (1 << 21, 1), (1 << 22, 1)]


def dev_us(e):
    """Device time of a profiler event of a CUDA kernel (the attribute's name
    varies by release), 0 for anything else."""
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
        return 0.0
    return float(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))


def device_ms(torch, fn, names, iters=20):
    """Device time per call of ``fn``'s CUDA kernels whose names contain one
    of ``names`` (torch.profiler over ``iters`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(dev_us(e) for e in prof.key_averages() if any(k in e.key for k in names))
    if not us > 0:
        raise AssertionError(f"the profiler recorded no device time for {names}")
    return us / iters / 1e3


def check_k12(torch, tp, tf):
    """Phase 3 for K1/K2: the whole ops ``pfft`` (real and complex rows),
    ``pifft_real`` and ``pifft`` (K2 with complex output; on both spectra)
    against their plain versions at ``K12_CASES``; ``pfft`` of the first row
    against float64 numpy, and the round trips (``pifft_real`` on real rows,
    ``pifft`` on complex rows); the backward of ``pfft`` on complex rows
    (``n * pifft(g)``, the plain versions refused) against autograd through
    ``torch.fft``.  Inputs drawn on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(R, n):
        return torch.randn(R, n, generator=g, device=dev)
    for n, R in K12_CASES:
        x = randn(R, n) + 2.0
        xc, gc = torch.complex(randn(R, n), randn(R, n)), torch.complex(randn(R, n), randn(R, n))
        errs = []
        for rows in (x, xc):
            X = tp.pfft_plain(rows, n)
            errs.append(rel_err(tp.pfft(rows, n), X)[0])
            errs.append(rel_err(tp.pifft_real(X, n), tp.pifft_real_plain(X, n))[0])
            errs.append(rel_err(tp.pifft(X, n), tp.pifft_plain(X, n))[0])
        want = np.fft.fft(x[:1].cpu().double().numpy(), axis=-1)[:, tp.spectrum_perm(n)]
        got = tp.pfft(x[:1], n)
        e_op = rel_err(got, torch.from_numpy(want))[0]
        e_rt = float((tp.pifft_real(got, n) - x[:1]).abs().max())
        e_rtc = float((tp.pifft(tp.pfft(xc, n), n) - xc).abs().max())
        perm = torch.as_tensor(tp.spectrum_perm(n), device=dev)
        zg, zl = xc.clone().requires_grad_(), xc.clone().requires_grad_()
        with refuse_plain(tp, tf):
            b = torch.autograd.grad(tp.pfft(zg, n), zg, gc)[0]
        e_b = rel_err(b, torch.autograd.grad(torch.fft.fft(zl).index_select(-1, perm), zl,
                                             gc)[0])[0]
        log(f"  K1/K2 n=2^{int(math.log2(n))} R={R:2d}: max rel err vs plain: pfft real "
            f"{errs[0]:.3e}, complex {errs[3]:.3e}; pifft_real {errs[1]:.3e}, {errs[4]:.3e}; "
            f"pifft {errs[2]:.3e}, {errs[5]:.3e} (tol {TOL_KERNEL:.0e}); pfft vs float64 numpy "
            f"{e_op:.3e} (tol 3e-6); round trips {e_rt:.3e}, complex {e_rtc:.3e} abs (tol "
            f"2e-5); pfft's complex-row backward vs torch.fft autograd {e_b:.3e} (tol "
            f"{TOL_KERNEL:.0e})")
        if not (max(errs) < TOL_KERNEL and e_op < 3e-6 and max(e_rt, e_rtc) < 2e-5
                and e_b < TOL_KERNEL):
            raise AssertionError(f"K1/K2 disagree with their references at n={n}, R={R}")
        del x, xc, gc, X, got, zg, zl, b
        torch.cuda.empty_cache()


def phase_kernels(torch, tp, tf, extra=(), base=True):
    """Phase 3: every kernel against its plain version; times and bounds, at
    the serving path's shapes and the ``extra`` (n, R) of phases 6-8.  With
    ``base=False`` (``--multichip``), the ``extra`` shapes alone."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    if base:
        check_k12(torch, tp, tf)
    rows = {}
    for n, R in ([(1 << 14, 3), (N_MAIN, 1), (N_MAIN, 59)] if base else []) + list(extra):
        A, Bh, Bl, _ = tp._plan(n)
        x = torch.randn(R, n, generator=g).to(dev) + 2.0
        mx = x.mean(-1)
        xm = (x - mx[:, None]).contiguous()
        wk = (torch.rand(Bh, A, Bl, generator=g) + 0.1).to(dev)
        perm = torch.as_tensor(tp.spectrum_perm(n), device=dev)
        inv_perm = torch.argsort(perm)
        w_nat = torch.empty(n, device=dev)
        w_nat[perm] = wk.reshape(n)
        w_perm = wk.reshape(n) * n       # pfft_quad's weights (it folds in 1/n)

        X = tp.pfft(x, n)
        e1 = rel_err(X, tp.pfft_plain(x, n))
        xb = tp.pifft_real(X, n)
        e2 = rel_err(xb, tp.pifft_real_plain(X, n))
        q = tp.quad_partials(x, wk, n, mx)
        e3 = rel_err(q.sum(-1), tp.quad_plain(xm, wk, n).sum(-1))
        if n == N_MAIN and R == 59:
            # the last query chunk's rows and the plans the main path does not run
            for n3, R3 in [(1 << 15, 2), (1 << 17, 3), (N_MAIN, 25), (1 << 22, 1)]:
                A3, Bh3, Bl3, _ = tp._plan(n3)
                x3 = torch.randn(R3, n3, generator=g).to(dev) + 2.0
                m3 = x3.mean(-1)
                wk3 = (torch.rand(Bh3, A3, Bl3, generator=g) + 0.1).to(dev)
                rel3 = rel_err(tp.quad_partials(x3, wk3, n3, m3).sum(-1),
                               tp.quad_plain(x3 - m3[:, None], wk3, n3).sum(-1))[0]
                log(f"  K3 quad       n=2^{int(math.log2(n3))} R={R3:2d}: max rel err vs plain "
                    f"{rel3:.3e} (tol {TOL_KERNEL:.0e})")
                if not rel3 < TOL_KERNEL:
                    raise AssertionError(f"K3 disagrees with its plain version at n={n3}, R={R3}")
            del x3, wk3
        torch.cuda.synchronize()
        for name, (rel, ab) in (("K1 pfft", e1), ("K2 pifft_real", e2), ("K3 quad", e3)):
            log(f"  {name:13s} n=2^{int(math.log2(n))} R={R:2d}: max rel err vs plain "
                f"{rel:.3e} (tol {TOL_KERNEL:.0e}), max abs {ab:.3e}")
            if not rel < TOL_KERNEL:
                raise AssertionError(f"{name} disagrees with its plain version at n={n}, R={R}")

        # pfft_quad against float64 numpy (one row; the JAX package's tolerance)
        x0 = x[:1].cpu().double().numpy()
        xm0 = x0 - x0.mean(-1, keepdims=True)
        sp = np.fft.fft(xm0, axis=-1)[:, tp.spectrum_perm(n)] / math.sqrt(n)
        sp[:, 0] += x0.mean() * math.sqrt(n)
        wfull = wk.reshape(n).double().cpu().numpy() * n
        want_q = (wfull * np.abs(sp) ** 2).sum(-1)
        e_q = rel_err(tp.pfft_quad(x[:1], w_perm, n), torch.from_numpy(want_q))[0]
        log(f"  pfft_quad vs float64 numpy {e_q:.3e} (tol 3e-6)")
        if not e_q < 3e-6:
            raise AssertionError(f"pfft_quad disagrees with float64 numpy at n={n}")

        it_k, it_p = (50, 10) if R == 1 else (10, 3)
        # second K3 yardstick: the real-input FFT, each conjugate pair's weights summed
        w_r = w_nat[:n // 2 + 1].clone()
        w_r[1:n // 2] += w_nat.flip(0)[:n // 2 - 1]
        e_r = rel_err((w_r * torch.fft.rfft(xm).abs().square()).sum(-1),
                      tp.quad_plain(xm, wk, n).sum(-1))[0]
        log(f"  K3 n=2^{int(math.log2(n))} R={R:2d}: rfft + folded weights "
            f"{gtime(lambda: (w_r * torch.fft.rfft(xm).abs().square()).sum(-1), it_k):.4f} ms "
            f"(rel err vs plain {e_r:.1e})")
        # K1/K2: the whole op is the two launches; "kernel" is their device time
        t = {
            "K1": (device_ms(torch, lambda: tp.pfft(x, n), ("pass_a_kernel", "pfft_slab_kernel")),
                   gtime(lambda: tp.pfft_plain(x, n), it_p),
                   # library: the whole pfft (DFT + gather to the permuted order)
                   gtime(lambda: torch.fft.fft(x).index_select(-1, perm), it_k),
                   gtime(lambda: tp.pfft(x, n), it_k),
                   nbytes(x, X),
                   fft_flops(n, R)),
            "K2": (device_ms(torch, lambda: tp.pifft_real(X, n),
                             ("pifft_slab_kernel", "pass_a_kernel")),
                   gtime(lambda: tp.pifft_real_plain(X, n), it_p),
                   gtime(lambda: torch.fft.ifft(X.index_select(-1, inv_perm)).real, it_k),
                   gtime(lambda: tp.pifft_real(X, n), it_k),
                   nbytes(X, xb),
                   fft_flops(n, R)),
            "K3": (gtime(lambda: tp.quad_partials(x, wk, n, mx), it_k),
                   gtime(lambda: tp.quad_plain(xm, wk, n), it_p),
                   gtime(lambda: (w_nat * torch.fft.fft(xm).abs().square()).sum(-1), it_k),
                   gtime(lambda: tp.pfft_quad(x, w_perm, n), it_k),
                   nbytes(xm, wk, q),
                   quad_flops(n, R)),
        }
        for k, (ms, pms, lms, oms, nb, fl) in t.items():
            bms, by = bound(nb, fl)
            log(f"  {k} n=2^{int(math.log2(n))} R={R:2d}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"library {lms:.4f} ms, whole op {oms:.4f} ms; bound {bms:.4f} ms by {by} "
                f"({nb / 1e6:.1f} MB, {fl / 1e9:.3f} GFLOP)")
            err = {"K1": e1, "K2": e2, "K3": e3}[k][1]
            rows[(k, n, R)] = dict(ms=ms, plain_ms=pms, library_ms=lms, op_ms=oms,
                                   bound_ms=bms, bound_by=by, max_abs_err=err)
        del x, xm, X, xb
        torch.cuda.empty_cache()
    return rows


def cfft_flops(n, R):
    """Least FLOPs of a complex FFT of length n (5 n log2 n a row), the work
    of ``pifft`` whatever the kernel does."""
    return R * n * 5 * math.log2(n)


def phase_pifft(torch, tp, tf, ttr):
    """Phase 3 for K2 with complex output (``pifft``; ``check_k12`` holds it
    against its plain version at every split): at n = 2^20, R = 1 the device
    time of its two launches, the op in a CUDA graph, the plain version, the
    library yardstick (``torch.fft.ifft`` after the permutation gather) and
    the bound.  Then its path, with the plain versions refused and the
    launch counters reset just before and read just after:
    ``transforms.pifft_ortho`` of a spectrum and the backward of ``pfft`` on
    complex rows at n = 2^20, R = 1.  Returns the role's row and the path's
    launch counts."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def crandn(R, n):
        return torch.complex(torch.randn(R, n, generator=g, device=dev),
                             torch.randn(R, n, generator=g, device=dev))
    n, R = N_MAIN, 1
    X = tp.pfft(crandn(R, n), n)
    out = tp.pifft(X, n)
    inv_perm = torch.argsort(torch.as_tensor(tp.spectrum_perm(n), device=dev))
    bms, by = bound(nbytes(X, out), cfft_flops(n, R))
    row = dict(ms=device_ms(torch, lambda: tp.pifft(X, n), ("pifft_slab_kernel", "pass_a_kernel")),
               op_ms=gtime(lambda: tp.pifft(X, n), 50),
               plain_ms=gtime(lambda: tp.pifft_plain(X, n), 10),
               library_ms=gtime(lambda: torch.fft.ifft(X.index_select(-1, inv_perm)), 50),
               bound_ms=bms, bound_by=by, max_abs_err=rel_err(out, tp.pifft_plain(X, n))[1])
    log(f"  K2 pifft n=2^20 R=1: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, whole op {row['op_ms']:.4f} ms; bound "
        f"{bms:.4f} ms by {by} ({nbytes(X, out) / 1e6:.1f} MB, "
        f"{cfft_flops(n, R) / 1e9:.3f} GFLOP)")

    Z, gc = crandn(R, n), crandn(R, n)
    zg = crandn(R, n).requires_grad_()
    with refuse_plain(tp, tf):
        for c in (tp, tf):
            c.reset_launches()
        v = ttr.pifft_ortho(Z, n)
        b = torch.autograd.grad(tp.pfft(zg, n), zg, gc)[0]
        torch.cuda.synchronize()
        counts = {k: v_ for c in (tp, tf) for k, v_ in c.launches.items()}
    e_v = rel_err(v, tp.pifft_plain(Z, n) * math.sqrt(n))[0]
    e_b = rel_err(b, tp.pifft_plain(gc, n) * float(n))[0]
    log(f"  its path (pifft_ortho, then pfft's backward on a complex row; plain versions "
        f"refused): launches {counts}; pifft_ortho vs plain {e_v:.3e}, the backward vs "
        f"n * plain {e_b:.3e} (tol {TOL_KERNEL:.0e})")
    if counts["pifft"] != 2 or not max(e_v, e_b) < TOL_KERNEL:
        raise AssertionError("pifft's path: not two launches of K2 with complex output, "
                             "or a result off its plain version")
    return row, counts


def si_cross_times(torch, sc, series):
    """Phase 3's K5: the lattice's query chunk (R = 59 rows against n = 2^20
    columns, d = 8, alpha = 2, float32, one hyperparameter row) through the
    kernel against its plain version (TOL_K5 of the largest value) and
    against the plain version in float64; times in CUDA graphs (``gtime``)
    of the kernel, the plain version, the whole ``kernel_fused_scan``
    through the kernel ("op") and the loop it replaced on the same inputs;
    the bound: the output stored and the columns read once, or the least
    FLOPs of the folded series, 2 + 2 deg a (row, column, dimension) (the
    difference, deg = 2 alpha fused multiply-adds, the product), whichever
    takes longer; then the paired layout (the chunk's prior diagonal, 59
    values)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    R, n, a = NB_LATTICE, N_MAIN, 2
    x = torch.rand((R, D), generator=g, device="cuda")
    z = torch.rand((n, D), generator=g, device="cuda")
    s = torch.full((1,), 1.3, device="cuda")
    ls = torch.rand((1, D), generator=g, device="cuda") + 0.5
    alpha, zero, one = np.full(D, a), np.zeros((1, D), dtype=np.int64), np.ones(1)
    tb = sc.table(alpha, zero, zero, one, one, torch.float32, x.device)
    tb64 = sc.table(alpha, zero, zero, one, one, torch.float64, x.device)
    run = lambda: sc.si_cross(x, z, alpha, zero, zero, one, one, s, ls)
    plain = lambda: sc.si_cross_plain(x, z, tb, s, ls)
    part = lambda dl, j, b, k: series.si_part_dim(dl, a, b, k)
    fused = lambda bern: series.kernel_fused_scan(part, x[:, None], z[None], series.lattice_ominus,
                                                  zero, zero, one, one, s, ls[0], alpha,
                                                  bernoulli=bern)
    got = run()
    err, abs_err = rel_err(got, plain())
    err64 = rel_err(got, sc.si_cross_plain(x.double(), z.double(), tb64, s.double(),
                                           ls.double()))[0]
    err_op = rel_err(fused(True), fused(False))[0]
    del got
    log(f"  K5 (n=2^20, R={R}, d={D}): vs plain {err:.3e} (tol {TOL_K5:.0e}), max abs "
        f"{abs_err:.3e}; vs float64 plain {err64:.3e}; kernel_fused_scan through K5 vs the "
        f"loop {err_op:.3e}")
    if not (err < TOL_K5 and err64 < TOL_K5 and err_op < TOL_K5):
        raise AssertionError("K5 disagrees with its plain version or the loop")
    nb = R * n * 4 + n * D * 4 + R * D * 4
    b_ms, b_by = bound(nb, R * n * D * (2 + 2 * (2 * a)))
    ms = gtime(run, 50)
    op_ms = gtime(lambda: fused(True), 50)
    plain_ms = gtime(plain, 3)
    loop_ms = gtime(lambda: fused(False), 3)
    pair = lambda: sc.si_cross(x, x, alpha, zero, zero, one, one, s, ls, paired=True)
    e_pair = rel_err(pair(), sc.si_cross_plain(x, x, tb, s, ls, paired=True))[0]
    pair_ms = gtime(pair, 200)
    log(f"  K5: kernel {ms:.4f} ms, op {op_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), plain "
        f"{plain_ms:.4f} ms, the loop it replaced {loop_ms:.4f} ms; paired (R={R}) "
        f"{pair_ms:.4f} ms, vs plain {e_pair:.3e}")
    if not e_pair < TOL_K5:
        raise AssertionError("K5's paired layout disagrees with its plain version")
    return {"max_abs_err": abs_err, "rel_err": err, "rel_err_f64": err64, "ms": ms,
            "op_ms": op_ms, "plain_ms": plain_ms, "loop_ms": loop_ms, "bound_ms": b_ms,
            "bound_by": b_by, "paired_ms": pair_ms}


def _f(x):
    return np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x.sum(1)


def _raw_params(seed=7):
    """Hyperparameters from a seed, in the JAX package's raw layout."""
    rng = np.random.default_rng(seed)
    return {"scale": np.zeros(1), "lengthscales": rng.uniform(-0.5, 0.5, D),
            "noise": np.log([1e-8]), "factor_task_kernel": np.zeros((1, 0)),
            "noise_task_kernel": np.zeros(1)}


def phase_serving(torch, ft, counters, cls, solver, path_kernels, ours, no_centred_copy=False,
                  per_chunk=()):
    """Phase 2: the n = 2^20, d = 8 serving path of one model on the card.
    ``path_kernels``: the launch counters its run must move; ``per_chunk``:
    those the first ``post_mean_var`` must move by exactly its number of
    query chunks (a chunk sent back to a slower path would not); ``ours``: the
    substrings of their CUDA kernel names in the profile; ``no_centred_copy``:
    fail if the profiled request subtracts row means from a whole query chunk
    (``x - x.mean(-1, keepdim=True)``: K4 centres on load)."""
    sync = torch.cuda.synchronize
    xq = torch.as_tensor(np.random.default_rng(11).uniform(size=(N_QUERY, D)), device="cuda")
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    gp = cls(D, seed_for_seq=7, alpha=2)
    x = gp.get_x_next(N_MAIN)
    y = torch.sin(2 * math.pi * x[:, 0]) * torch.cos(2 * math.pi * x[:, 1]) + x.sum(1)
    gp.add_y_next(y)
    ft.load_jax_params(gp, _raw_params())
    sync()
    lat = {"setup (points, data, params)": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gp._warm_for_query(gp.n)           # k1parts, ytilde
    sync()
    lat["cache warm-up (k1parts, ytilde)"] = time.perf_counter() - t0
    out = {}
    for i in range(3):
        before = {k: v for c in counters for k, v in c.launches.items()}
        t0 = time.perf_counter()
        out[f"post_mean_var#{i}"] = gp.post_mean_var(xq)
        sync()
        lat[f"post_mean_var#{i} (N={N_QUERY})"] = time.perf_counter() - t0
        if i == 0:
            first = {k: v - before[k] for c in counters for k, v in c.launches.items()}
    for name, call in (("post_mean", lambda: gp.post_mean(xq)),
                       ("post_var", lambda: gp.post_var(xq)),
                       ("post_cubature_mean", gp.post_cubature_mean),
                       ("post_cubature_var", gp.post_cubature_var)):
        t0 = time.perf_counter()
        out[name] = call()
        sync()
        lat[name] = time.perf_counter() - t0
    counts = {k: v for c in counters for k, v in c.launches.items()}
    for k, v in lat.items():
        log(f"  {k}: {v * 1e3:.1f} ms")
    log(f"  peak device memory allocated during the requests: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; query chunk "
        f"{gp._query_chunk_size(N_QUERY, N_MAIN)} rows")
    log(f"  kernel launches on the main path: {counts}")
    if type(gp._solver()).__name__ != solver or gp.dtype != torch.float32:
        raise AssertionError(f"the card model did not take the float32 {solver} path")
    if not all(counts[k] > 0 for k in path_kernels):
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    chunks = -(-N_QUERY // gp._query_chunk_size(N_QUERY, N_MAIN))
    if per_chunk:
        log(f"  launches in the first post_mean_var ({chunks} query chunks): "
            f"{ {k: first[k] for k in per_chunk} }")
    if any(first[k] != chunks for k in per_chunk):
        raise AssertionError(f"{per_chunk}: not one launch a query chunk ({chunks}): {first}")

    pm, pv = out["post_mean_var#0"]
    for k, v in out.items():
        for t in (v if isinstance(v, tuple) else (v,)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{k}: non-finite output")
    if pm.shape != (N_QUERY,) or pv.shape != (N_QUERY,) or bool((pv < 0).any()):
        raise AssertionError("post_mean_var: wrong shape or negative variance")
    for i in (1, 2):
        if not (torch.equal(out[f"post_mean_var#{i}"][0], pm)
                and torch.equal(out[f"post_mean_var#{i}"][1], pv)):
            raise AssertionError("repeated post_mean_var differs (kernels must be deterministic)")
    e_mean = rel_err(out["post_mean"], pm)[0]
    e_var = rel_err(out["post_var"], pv)[0]
    cm, cv = float(out["post_cubature_mean"]), float(out["post_cubature_var"])
    # reference: the same model in float64 on the CPU
    ref = cls(D, seed_for_seq=7, alpha=2, dtype=torch.float64, device="cpu")
    xh = ref.get_x_next_host(N_MAIN)
    ref.add_y_next(torch.from_numpy(_f(xh)))
    ft.load_jax_params(ref, _raw_params())
    cm64, cv64 = float(ref.post_cubature_mean()), float(ref.post_cubature_var())
    log(f"  post_mean vs post_mean_var {e_mean:.2e}, post_var vs post_mean_var {e_var:.2e}")
    log(f"  cubature mean {cm:.8f} vs float64 CPU {cm64:.8f}: rel {abs(cm / cm64 - 1):.2e} "
        f"(tol 5e-5); cubature var {cv:.4e} vs {cv64:.4e}: abs {abs(cv - cv64):.2e} (tol 2e-5: "
        f"scale minus an O(scale) term, resolved in float32 to ~1e-5 of scale)")
    if e_mean > 1e-6 or e_var > 1e-6 or abs(cm / cm64 - 1) > 5e-5 or abs(cv - cv64) > 2e-5:
        raise AssertionError("serving outputs inconsistent")

    # device-time split of one more post_mean_var (not counted above)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=no_centred_copy) as prof:
        t0 = time.perf_counter()
        gp.post_mean_var(xq)
        sync()
        wall = time.perf_counter() - t0
    if no_centred_copy:
        nb = gp._query_chunk_size(N_QUERY, N_MAIN)
        subs = sum(e.count for e in prof.key_averages(group_by_input_shape=True)
                   if e.key in ("aten::sub", "aten::sub_")
                   and [nb, N_MAIN] in e.input_shapes and [nb, 1] in e.input_shapes)
        log(f"  row-mean subtractions over a ({nb}, 2^20) query chunk in the profiled "
            f"request: {subs}")
        if subs:
            raise AssertionError("the request wrote a centred copy of a query chunk")
    evs = [(dev_us(e), e) for e in prof.key_averages()]
    evs = sorted([(t, e) for t, e in evs if t > 0], key=lambda te: -te[0])
    total = sum(t for t, _ in evs)
    if total > 0:
        mine = sum(t for t, e in evs if any(o in e.key for o in ours))
        log(f"  profile of one post_mean_var: wall {wall * 1e3:.1f} ms, device busy "
            f"{total / 1e3:.1f} ms ({100 * total / 1e6 / wall:.1f}%), "
            f"{'/'.join(path_kernels)} kernels {mine / 1e3:.2f} ms "
            f"({100 * mine / total:.1f}% of device time)")
        for t, e in evs[:10]:
            log(f"    {t / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:100]}")
    else:
        log("  profile of one post_mean_var: no device time recorded (not measured)")
    return counts, gp._query_chunk_size(N_QUERY, N_MAIN)


def phase_crosscheck(torch, ft, cls, labels, tols):
    """Phase 4: n = 2^16, d = 8 on the card against the CPU paths.
    ``labels``: names of the card, CPU float32 and CPU float64 runs;
    ``tols``: per reference, limits on the max relative error of
    (post_mean, post_var, coeffs, cubature mean, cubature var)."""
    n = 1 << 16
    xq = np.random.default_rng(5).uniform(size=(256, D))
    res = {}
    for label, dev, dt in zip(labels, ("cuda", "cpu", "cpu"),
                              (torch.float32, torch.float32, torch.float64)):
        gp = cls(D, seed_for_seq=7, alpha=2, dtype=dt, device=dev)
        gp.add_y_next(torch.as_tensor(_f(gp.get_x_next_host(n))))
        ft.load_jax_params(gp, _raw_params())
        pm, pv = gp.post_mean_var(xq)
        res[label] = [t.double().cpu() for t in
                      (pm, pv, gp.coeffs, gp.post_cubature_mean(), gp.post_cubature_var())]
        log(f"  {label}: solver {type(gp._solver()).__name__}")
    names = ("post_mean", "post_var", "coeffs", "cubature mean", "cubature var")
    card = res[labels[0]]
    failed = []
    for ref, tol in zip(labels[1:], tols):
        errs = [rel_err(a, b)[0] for a, b in zip(card, res[ref])]
        log(f"  card vs {ref}: " + ", ".join(
            f"{nm} {e:.2e} (tol {t:.0e})" for nm, e, t in zip(names, errs, tol)))
        if not all(e < t for e, t in zip(errs, tol)):
            failed.append(ref)
    if failed:
        raise AssertionError(f"card path disagrees with the {', '.join(failed)}")


def np_fwht(x):
    """Orthonormal FWHT of the rows of a numpy array, in its own dtype: the
    radix-2 butterfly network, stages from the lowest index bit up (the
    order in which K4 runs them)."""
    R, n = x.shape
    y, h = x.copy(), 1
    while h < n:
        y = y.reshape(R, -1, 2, h)
        y = np.concatenate([y[:, :, :1] + y[:, :, 1:], y[:, :, :1] - y[:, :, 1:]], 2)
        y = y.reshape(R, n)
        h *= 2
    return y * x.dtype.type(1.0 / math.sqrt(n))


def fwht_shapes(nb, extra, base):
    """K4's (n, R) in phase 3: the digital-net path's, then ``extra``."""
    return ([(1 << 14, 3), (N_MAIN, 1), (N_MAIN, nb), (1 << 22, 1)] if base else []) + list(extra)


def fwht_times(torch, tf, ttr, nb, g, extra=(), base=True):
    """K4's times at the digital-net path's shapes and n = 2^14, R = 3, each a
    CUDA graph of repeated calls between events: ``warm`` calls on one input
    (in L2 when it fits), ``cold`` calls cycling through inputs larger than
    the L2 (the serving path's calls find theirs cold), ``op`` the whole
    ``ft_stable_fwht``.  Only the public API, so that it times an older
    checkout of the package as well (``--fwht-times``)."""
    out = {}
    for n, R in fwht_shapes(nb, extra, base):
        key = f"2^{int(math.log2(n))},{R}"
        x = torch.randn(R, n, generator=g).to("cuda")
        it = 50 if R == 1 else 10
        out[key] = {"warm": gtime(lambda: tf.fwht(x), it)}
        if R == 1:  # inputs of 96 MB in all, more than the 50 MB L2
            xs = [torch.randn(R, n, generator=g).to("cuda")
                  for _ in range(max(2, (24 << 20) // n))]
            k = [0]

            def rot():
                tf.fwht(xs[k[0] % len(xs)])
                k[0] += 1
            out[key]["cold"] = gtime(rot, 2 * len(xs))
            del xs
        if R == nb:
            out[key]["op"] = gtime(lambda: ttr.ft_stable_fwht(x), it)
        del x
        torch.cuda.empty_cache()
    return out


def phase_fwht(torch, tf, ttr, nb, extra=(), base=True):
    """Phase 3 for K4: against its plain version, float64 numpy and the
    float32 numpy butterflies (also centring on load); times, bounds, the
    group-size sweep and the HBM rate.  ``nb``: the query chunk's row count
    on the digital-net path; ``extra``: the (n, R) of phases 6-8.  With
    ``base=False`` (``--multichip``), the ``extra`` shapes alone, no sweep."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    rows = {}
    for n, R in fwht_shapes(nb, extra, base):
        m = int(math.log2(n))
        x = torch.randn(R, n, generator=g).to(dev) + 1.5
        k = tf.fwht(x)
        p = tf.fwht_plain(x)
        mu = x.mean(-1)
        km = tf.fwht(x, mu)
        torch.cuda.synchronize()
        rel, ab = rel_err(k, p)
        # the first rows against numpy: float64 (the true values), and float32
        # in the kernel's order of operations, which it must match bit for bit
        # (centred on load: against numpy centring first)
        r = min(R, 4)
        x0 = x[:r].cpu().numpy()
        k0 = k[:r].cpu().numpy()
        want = torch.from_numpy(np_fwht(x0.astype(np.float64)))
        e64 = rel_err(torch.from_numpy(k0), want)[0]
        same32 = bool(np.array_equal(k0, np_fwht(x0)))
        same_mean = bool(np.array_equal(km[:r].cpu().numpy(),
                                        np_fwht(x0 - mu[:r].cpu().numpy()[:, None])))
        # the float64 instantiation on the same values
        e_d = rel_err(tf.fwht(x[:r].double()), want)[0]
        log(f"  K4 fwht n=2^{m} R={R:3d}: max rel err vs plain {rel:.3e} (tol {16 * EPS32:.1e}, "
            f"16 ulps), vs float64 numpy {e64:.3e} (tol {4 * EPS32:.1e}), float32 numpy "
            f"butterflies bitwise equal: {same32}, centred on load: {same_mean}; float64 "
            f"kernel vs numpy {e_d:.1e} (tol 1e-13)")
        if not (rel < 16 * EPS32 and e64 < 4 * EPS32 and same32 and same_mean and e_d < 1e-13):
            raise AssertionError(f"K4 disagrees with its references at n={n}, R={R}")
        rows[(n, R)] = dict(max_abs_err=ab,
                            plain_ms=gtime(lambda: tf.fwht_plain(x), 10 if R == 1 else 3))
        del x, k, p, km
        torch.cuda.empty_cache()
    times = fwht_times(torch, tf, ttr, nb, g, extra, base)
    for (n, R), r in rows.items():
        m = int(math.log2(n))
        t = times[f"2^{m},{R}"]
        nbytes_ = 2 * 4 * R * n               # read once, write once
        flops = R * n * (m + 1)               # n log2 n adds and n scalings a row
        bms, by = bound(nbytes_, flops)
        r.update(ms=t["warm"], bound_ms=bms, bound_by=by, op_ms=t.get("op"))
        extra = "".join(f", {k} {v:.4f} ms" for k, v in t.items() if k != "warm")
        log(f"  K4 n=2^{m} R={R:3d}: kernel {t['warm']:.4f} ms (warm){extra}; plain "
            f"{r['plain_ms']:.4f} ms, library none; bound {bms:.4f} ms by {by} "
            f"({nbytes_ / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); the function's bytes at "
            f"{nbytes_ / t['warm'] / 1e9:.3f} TB/s")
    if not base:
        return rows
    # the pass-1 output of a group of rows that pass 2 reads back from L2
    x = torch.randn(nb, N_MAIN, generator=g).to(dev)
    sweep = {}
    for mb in (8, 12, 16, 32):
        plan = tf.fwht_plan(N_MAIN, nb, tf._sm_count(0), mb << 20, 4)
        sweep[mb] = gtime(lambda: tf._fwht_cuda(x, None, plan), 10)
    log(f"  K4 n=2^20 R={nb}: group size (pass-1 output) " + ", ".join(
        f"{mb} MB {ms:.4f} ms" for mb, ms in sweep.items()) + f"; in use "
        f"{tf.GROUP_BYTES >> 20} MB")
    del x
    torch.cuda.empty_cache()
    return rows


def device_events(prof):
    """(device ms, kernel launches) of the CUDA events in a profile."""
    evs = [(dev_us(e), e.count) for e in prof.key_averages()]
    return sum(t for t, _ in evs) / 1e3, sum(c for t, c in evs if t > 0)


def device_total_ms(torch, fn, iters=10):
    """Device time of all of ``fn``'s CUDA work per call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms, _ = device_events(prof)
    if not ms > 0:
        raise AssertionError("the profiler recorded no device time")
    return ms / iters


class refuse_plain:
    """Within the block, the plain versions of K1, K2 (both outputs) and K4
    raise: the card path must reach the kernels only."""

    def __init__(self, tp, tf):
        self.mods = ((tp, "pfft_plain"), (tp, "pifft_real_plain"), (tp, "pifft_plain"),
                     (tf, "fwht_plain"))

    def __enter__(self):
        self.saved = [getattr(m, k) for m, k in self.mods]

        def refuse(*a, **k):
            raise AssertionError("the card path reached a plain kernel version")
        for m, k in self.mods:
            setattr(m, k, refuse)

    def __exit__(self, *exc):
        for (m, k), f in zip(self.mods, self.saved):
            setattr(m, k, f)


def fit_model(torch, cls, n, dtype=None, device=None, d=D, **kw):
    """``bench.py``'s fit configuration: d = 8 (or ``d``), seed 7, alpha 2,
    y = sin(2 pi x0) cos(2 pi x1) + sum x, default hyperparameters."""
    gp = cls(d, seed_for_seq=7, alpha=2, dtype=dtype, device=device, **kw)
    gp.add_y_next(torch.as_tensor(_f(gp.get_x_next_host(n))))
    return gp


def fit_chain(torch, gp, lg, data, iters, K):
    """``iters`` fit steps (loss, gradient, Rprop update) as ``fit`` runs
    them with ``steps_per_dispatch`` K: losses fetched once per K steps;
    ended by ``torch.cuda.synchronize()``."""
    from fastgaussianprocesses_torch.fit.rprop import rprop_init
    raw = gp._raw_dict()
    opt = rprop_init(raw)
    trainable = {k: p.trainable for k, p in gp.params.items()}
    for _ in range(iters // K):
        steps, stats = gp._fit_steps(lg, raw, opt, data, trainable, K)
        _, raw, opt = steps[-1]
        if not all(math.isfinite(v[0]) for v in stats):
            raise AssertionError("non-finite loss in the timed fit steps")
    torch.cuda.synchronize()


def block_syncs(torch, gp, lg, data):
    """Host synchronisations of one block of ``fit(steps_per_dispatch=-1)``
    (``_fit_steps`` at K = 64, its one fetch included), counted under
    ``torch.cuda.set_sync_debug_mode("warn")``: one "called a synchronizing
    CUDA operation" warning a synchronising CUDA call (the mode's own
    first-use notice is not one)."""
    import warnings
    from fastgaussianprocesses_torch.fit.rprop import rprop_init
    from fastgaussianprocesses_torch.models.abstract import FUSED_BLOCK
    raw = gp._raw_dict()
    trainable = {k: p.trainable for k, p in gp.params.items()}
    gp._fit_steps(lg, raw, rprop_init(raw), data, trainable, 2)        # warm
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            gp._fit_steps(lg, raw, rprop_init(raw), data, trainable, FUSED_BLOCK)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in ws)


def fused_vs_k32(torch, tp, tf, cls, per_step, i32, r32):
    """``fit(iterations=20, verbose=0, steps_per_dispatch=-1)`` of a fresh
    model, the plain versions refused, the launch counters reset just before
    (the fit's caches warm) and read just after, against the K = 32 fit of
    the same start that ended at iteration ``i32`` with raw parameters
    ``r32``: the same iterations, raw parameters within rtol 1e-6 (and
    whether bit for bit), and each launch count ``per_step`` times the 21
    steps the one block computes."""
    steps = 21
    gp = fit_model(torch, cls, N_MAIN)
    gp._warm_for_fit()
    torch.cuda.synchronize()
    with refuse_plain(tp, tf):
        for c in (tp, tf):
            c.reset_launches()
        t0 = time.perf_counter()
        i1 = gp.fit(iterations=20, verbose=0, steps_per_dispatch=-1)["iterations"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for c in (tp, tf) for k, v in c.launches.items()}
    r1 = {k: p.raw.double().cpu() for k, p in gp.params.items()}
    rel = max(float(((r1[k] - r32[k]).abs() / r32[k].abs().clamp(min=1e-30)).max())
              for k in r32 if r32[k].numel())
    bitwise = all(torch.equal(r1[k], r32[k]) for k in r32)
    log(f"  fit(iterations=20, steps_per_dispatch=-1): {wall:.3f} s, {i1} iterations "
        f"(K = 32: {i32}), launches {counts}; raw parameters max rel diff from K = 32's "
        f"{rel:.3e} (tol 1e-6), bit for bit: {bitwise}")
    if i1 != i32 or not rel < 1e-6:
        raise AssertionError("the fused fit disagrees with K = 32")
    for k, m in per_step.items():
        if counts[k] != m * steps:
            raise AssertionError(f"fused fit: {k} launched {counts[k]} times, not {m} x {steps}")
    return dict(iterations=i1, iterations_K32=i32, raw_max_rel_diff=rel, bit_for_bit=bitwise,
                launches=counts, wall_s=wall)


def phase_fit(torch, ft, tp, tf, cls, solver, per_step, ours, cv_per_step=None):
    """Phase 5: ``fit(iterations=20)`` of one model at n = 2^20, d = 8, float32
    on the card with the plain kernel versions refused; the launch counters
    (reset just before) must grow by ``per_step`` a step.  Then the step's
    times (``bench.py:bench_fit_steps``: best of 3 chains, per step, at
    ``steps_per_dispatch`` 1 and 32), its profile (device busy share,
    launches, the kernels ``ours``, the series contraction forward and
    backward) and peak device memory.  ``cv_per_step``: also a short CV fit
    (coefficients through ``pifft_real``, whose backward is K1), with its
    launches a step.  Then the fused fit (``steps_per_dispatch=-1``) against
    K = 32 (``fused_vs_k32``), its step (the K = 64 loop) timed beside K = 1
    and K = 32, and the host synchronisations of one of its blocks
    (``block_syncs``).  Returns the launch counts and the measurements."""
    from fastgaussianprocesses_torch.kernels import series
    sync = torch.cuda.synchronize
    gp = fit_model(torch, cls, N_MAIN)
    before = {k: p.raw.clone() for k, p in gp.params.items()}
    with refuse_plain(tp, tf):
        for c in (tp, tf):
            c.reset_launches()
        t0 = time.perf_counter()
        out = gp.fit(iterations=20, verbose=0, store_loss_hist=True)
        sync()
        wall = time.perf_counter() - t0
        counts = {k: v for c in (tp, tf) for k, v in c.launches.items()}
    k32 = (out["iterations"], {k: p.raw.double().cpu() for k, p in gp.params.items()})
    steps = 21          # iterations 0..20, all computed in one dispatch of K = 32
    lh = out["loss_hist"]
    log(f"  fit(iterations=20): {wall:.3f} s, {out['iterations']} iterations, MLL "
        f"{lh[0]:.6e} -> {lh[-1]:.6e}; launches {counts}")
    if type(gp._solver()).__name__ != solver or gp.dtype != torch.float32:
        raise AssertionError(f"the card model did not take the float32 {solver} path")
    if not np.isfinite(lh).all() or len(lh) != out["iterations"] + 1:
        raise AssertionError("fit: non-finite or missing losses")
    for k, p in gp.params.items():
        if torch.equal(p.raw, before[k]) == p.trainable:
            raise AssertionError(f"fit: {k} {'did not move' if p.trainable else 'moved'}")
    for k, m in per_step.items():
        if counts[k] < m * steps:
            raise AssertionError(f"fit: {k} launched {counts[k]} times in {steps} steps")
    if cv_per_step:
        with refuse_plain(tp, tf):
            for c in (tp, tf):
                c.reset_launches()
            out = gp.fit(loss_metric="CV", iterations=3, verbose=0, store_loss_hist=True)
            cv_counts = {k: v for c in (tp, tf) for k, v in c.launches.items()}
        log(f"  fit(loss_metric='CV', iterations=3): CV {out['loss_hist'][0]:.6e} -> "
            f"{out['loss_hist'][-1]:.6e}; launches {cv_counts}")
        if not np.isfinite(out["loss_hist"]).all() or any(
                cv_counts[k] < m * 4 for k, m in cv_per_step.items()):
            raise AssertionError("CV fit: non-finite loss or a kernel short of its launches")
        counts["cv"] = cv_counts
    fused = fused_vs_k32(torch, tp, tf, cls, per_step, *k32)
    counts["fused"] = fused["launches"]

    gp = fit_model(torch, cls, N_MAIN)
    mll_const = N_MAIN * math.log(2 * math.pi)
    lg = gp._make_loss_fn("MLL", None, 1, mll_const, 1)
    data = gp._fit_data()
    res = {}
    with refuse_plain(tp, tf):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for K in (1, 32):
            fit_chain(torch, gp, lg, data, 32, K)
        # the three step modes in turns, best of 3 each; -1 is the K = 64 loop
        for _ in range(3):
            for K in (1, 32, 64):
                t0 = time.perf_counter()
                fit_chain(torch, gp, lg, data, 64, K)
                ms = (time.perf_counter() - t0) / 64 * 1e3
                key = "step_ms_K-1" if K == 64 else f"step_ms_K{K}"
                res[key] = min(res.get(key, math.inf), ms)
        res.update(fused_block_syncs=block_syncs(torch, gp, lg, data), fused=fused)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["peak_above_base_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit_chain(torch, gp, lg, data, 8, 8)
            wall = (time.perf_counter() - t0) / 8
    dev_ms, nlaunch = device_events(prof)
    evs = sorted([(dev_us(e), e) for e in prof.key_averages() if dev_us(e) > 0],
                 key=lambda te: -te[0])
    mine = sum(t for t, e in evs if any(o in e.key for o in ours)) / 1e3 / 8
    res.update(wall_ms=wall * 1e3, device_ms=dev_ms / 8, launches=nlaunch / 8, kernels_ms=mine)
    # the series contraction alone, forward and forward + backward
    params = gp._transformed({k: v.detach().requires_grad_(gp.params[k].trainable)
                              for k, v in gp._raw_dict().items()})
    k1p = data[0][0]
    d0, c0 = gp.derivatives[0], gp.derivatives_coeffs[0]
    g = torch.randn(N_MAIN, device=gp.device)

    def contraction():
        return series.kernel_from_parts_t(k1p, d0, d0, c0, c0, params["scale"],
                                          params["lengthscales"])

    def fwd():
        with torch.no_grad():
            contraction()
    res["contraction_fwd_ms"] = device_total_ms(torch, fwd)
    res["contraction_fwd_bwd_ms"] = device_total_ms(
        torch, lambda: torch.autograd.grad(contraction(),
                                           (params["scale"], params["lengthscales"]), g))
    # its plain version: autograd through the product written out in place
    ind = series.pair_consts(d0, d0, c0, c0, k1p.dtype, k1p.device)[0]

    def contraction_plain():
        terms = None
        for j in range(D):
            f = ind[:, :, j, None] + params["lengthscales"][j] * k1p[..., j, :]
            terms = f if terms is None else terms.mul_(f)
        return params["scale"] * terms.sum((0, 1))
    res["contraction_plain_fwd_bwd_ms"] = device_total_ms(
        torch, lambda: torch.autograd.grad(contraction_plain(),
                                           (params["scale"], params["lengthscales"]), g))
    log(f"  step (loss, gradient, Rprop update), best of 3 chains of 64 steps: "
        f"{res['step_ms_K1']:.3f} ms at steps_per_dispatch 1, {res['step_ms_K32']:.3f} ms at "
        f"32, {res['step_ms_K-1']:.3f} ms at -1 (blocks of 64); peak device "
        f"memory {res['peak_gib']:.3f} GiB, of which the steps' own "
        f"{res['peak_above_base_gib']:.3f} GiB (the rest was allocated before: caches, data)")
    log(f"  host synchronisations of one block of 64 steps at -1, its fetch included: "
        f"{res['fused_block_syncs']}")
    if res["fused_block_syncs"] != 1:
        raise AssertionError("a block of the fused fit synchronises the host more than once")
    log(f"  profile of 8 steps (K = 8): wall {res['wall_ms']:.3f} ms a step, device busy "
        f"{res['device_ms']:.4f} ms ({100 * res['device_ms'] / res['wall_ms']:.1f}%), "
        f"{res['launches']:.1f} device launches a step; {'/'.join(per_step)} kernels "
        f"{res['kernels_ms']:.4f} ms a step; series contraction forward "
        f"{res['contraction_fwd_ms']:.4f} ms, forward + backward "
        f"{res['contraction_fwd_bwd_ms']:.4f} ms (autograd through the loop written out: "
        f"{res['contraction_plain_fwd_bwd_ms']:.4f} ms; device time)")
    for t, e in evs[:12]:
        log(f"    {t / 1e3 / 8:9.4f} ms  x{e.count / 8:<5.1f} {e.key[:100]}")
    return counts, res


def fit_grad_check(torch, ft, tp, tf, cls, labels):
    """The MLL and its gradient at n = 2^16, d = 8, noise 1.0 (noise trained
    too): the card's float32 path against the CPU's float32 plain kernels
    and the CPU's float64 path, the latter also evaluated with float32's
    eigenvalue floor (``fs.EIG_FLOOR_C`` scaled by eps32 / eps64).  The
    floor lifts every eigenvalue by 8 eps max|lam|, which at this size moves
    the float32 MLL of the digital net by ~6e-4 from float64's: the loss is
    held within rtol 2e-4 of the CPU float32 and of the floor-matched
    float64 evaluations.  Every gradient entry above 1e-3 of its parameter's
    largest agrees in sign with each reference (the differentiated floor
    makes each backend's gradient that of its own floored surface,
    ``tests/test_pallas_fft.py:141-175``); on the card every trainable
    gradient entry is non-zero."""
    from fastgaussianprocesses_torch.linalg import fast_solver as fs
    n = 1 << 16
    res = {}
    floor_c = fs.EIG_FLOOR_C
    runs = list(zip(labels, ("cuda", "cpu", "cpu"), (torch.float32, torch.float32, torch.float64),
                    (1.0, 1.0, 1.0)))
    runs.append((labels[2] + " (float32 floor)", "cpu", torch.float64,
                 EPS32 / float(np.finfo(np.float64).eps)))
    for label, dev, dt, fscale in runs:
        gp = fit_model(torch, cls, n, dtype=dt, device=dev, noise=1.0, requires_grad_noise=True)
        lg = gp._make_loss_fn("MLL", None, 1, n * math.log(2 * math.pi), 1)
        fs.EIG_FLOOR_C = floor_c * fscale
        try:
            if dev == "cuda":
                with refuse_plain(tp, tf):
                    loss, _, grads = lg(gp._raw_dict(), gp._fit_data())
            else:
                loss, _, grads = lg(gp._raw_dict(), gp._fit_data())
        finally:
            fs.EIG_FLOOR_C = floor_c
        res[label] = (float(loss), {k: grads[k].double().cpu().numpy() for k in grads
                                    if gp.params[k].trainable})
        log(f"  {label}: solver {type(gp._solver()).__name__}, MLL {float(loss):.8e}, grads "
            + ", ".join(f"{k} {np.array2string(v, precision=4)}" for k, v in res[label][1].items()))
    v0, g0 = res[labels[0]]
    if not all((v != 0).all() for v in g0.values()):
        raise AssertionError("a trainable gradient entry is zero on the card")
    for ref, lossref in zip(list(res)[1:], (True, False, True)):
        v1, g1 = res[ref]
        for k in g0:
            big = np.abs(g1[k]) > 1e-3 * np.abs(g1[k]).max()
            if not (np.sign(g0[k][big]) == np.sign(g1[k][big])).all():
                raise AssertionError(f"gradient sign of {k}: card vs {ref}")
        log(f"  card vs {ref}: MLL rel {abs(v0 / v1 - 1):.2e}"
            f"{' (tol 2e-4)' if lossref else ''}, gradient signs agree")
        if lossref and not abs(v0 / v1 - 1) < 2e-4:
            raise AssertionError(f"MLL: card vs {ref}")


def backward_checks(torch, tp, tf):
    """Each backward alone on the card, against a library yardstick (autograd
    through ``torch.fft`` and the ``spectrum_perm`` gather; for K4 in float64,
    the CPU plain version), at n = 2^14, 2^20, 2^22 and R = 1, 3, at the
    kernels' limits; device times beside the yardstick's at n = 2^20, R = 1."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    rows = {}
    for n in (1 << 14, N_MAIN, 1 << 22):
        perm = torch.as_tensor(tp.spectrum_perm(n), device=dev)
        inv_perm = torch.argsort(perm)
        for R in (1, 3):
            x = (torch.randn(R, n, generator=g) + 2.0).to(dev).requires_grad_()
            gc = torch.complex(torch.randn(R, n, generator=g), torch.randn(R, n, generator=g)).to(dev)
            X = gc.clone().requires_grad_()
            gr = torch.randn(R, n, generator=g).to(dev)
            y1, y1l = tp.pfft(x, n), torch.fft.fft(x.to(torch.complex64)).index_select(-1, perm)
            y2, y2l = tp.pifft_real(X, n), torch.fft.ifft(X.index_select(-1, inv_perm)).real
            with refuse_plain(tp, tf):
                b1 = torch.autograd.grad(y1, x, gc, retain_graph=True)[0]
                b2 = torch.autograd.grad(y2, X, gr, retain_graph=True)[0]
            e1 = rel_err(b1, torch.autograd.grad(y1l, x, gc, retain_graph=True)[0])
            e2 = rel_err(b2, torch.autograd.grad(y2l, X, gr, retain_graph=True)[0])
            x64 = torch.randn(R, n, generator=g, dtype=torch.float64)
            xd = x64.to(dev).requires_grad_()
            yd = tf.fwht(xd)
            with refuse_plain(tp, tf):
                b4 = torch.autograd.grad(yd, xd, xd.detach(), retain_graph=True)[0]
            e4 = rel_err(b4, tf.fwht_plain(x64))
            x32 = xd.detach().float().requires_grad_()
            y32 = tf.fwht(x32)
            with refuse_plain(tp, tf):
                b432 = torch.autograd.grad(y32, x32, x32.detach(), retain_graph=True)[0]
            e432 = rel_err(b432, tf.fwht_plain(x64.float()))
            log(f"  backward n=2^{int(math.log2(n))} R={R}: pfft (K2) {e1[0]:.3e}, pifft_real "
                f"(K1) {e2[0]:.3e} of the max vs torch.fft autograd (tol {TOL_KERNEL:.0e}); fwht "
                f"(K4) float64 {e4[0]:.1e} (tol 1e-13), float32 {e432[0]:.2e} (tol "
                f"{16 * EPS32:.1e}) vs the CPU plain version")
            if not (e1[0] < TOL_KERNEL and e2[0] < TOL_KERNEL and e4[0] < 1e-13
                    and e432[0] < 16 * EPS32):
                raise AssertionError(f"a backward disagrees with its yardstick at n={n}, R={R}")
            if n == N_MAIN and R == 1:
                def grad_of(y, x, gg):
                    return lambda: torch.autograd.grad(y, x, gg, retain_graph=True)
                ms = {
                    "K2 as pfft's backward": (
                        device_total_ms(torch, grad_of(y1, x, gc), 20),
                        device_total_ms(torch, grad_of(y1l, x, gc), 20),
                        gtime(lambda: tp.pifft_real_plain(gc, n) * float(n), 10),
                        nbytes(gc, x), fft_flops(n, R), e1[1]),
                    "K1 as pifft_real's backward": (
                        device_total_ms(torch, grad_of(y2, X, gr), 20),
                        device_total_ms(torch, grad_of(y2l, X, gr), 20),
                        gtime(lambda: tp.pfft_plain(gr, n) * (1.0 / n), 10),
                        nbytes(gr, gc), fft_flops(n, R), e2[1]),
                    "K4 as fwht's backward": (
                        device_total_ms(torch, grad_of(y32, x32, x32.detach()), 20), None,
                        gtime(lambda: tf.fwht_plain(x32.detach()), 10),
                        nbytes(x32, x32), R * n * (math.log2(n) + 1), e432[1]),
                }
                for k, (kms, lms, pms, nb, fl, err) in ms.items():
                    bms, by = bound(nb, fl)
                    rows[k] = dict(ms=kms, library_ms=lms, plain_ms=pms, bound_ms=bms,
                                   bound_by=by, max_abs_err=err)
                    log(f"  {k} n=2^20 R=1: device {kms:.4f} ms, library (torch.fft "
                        f"autograd) {'none' if lms is None else f'{lms:.4f} ms'}, plain "
                        f"{pms:.4f} ms; bound {bms:.4f} ms by {by}")
            del x, X, gc, gr, y1, y1l, y2, y2l, xd, yd, x32, y32
            torch.cuda.empty_cache()
    return rows


# ---- phase 6: multitask, derivative-informed and fleet models ---------------------------

MT_NS = (N_MAIN, N_MAIN // 2, N_MAIN // 4)   # multi-fidelity: r = (4, 2, 1), M = 7
N_DERIV = 1 << 16
N_FLEET, B_FLEET = 1 << 16, 8
NB_MT = 68                # query chunk rows of mt_dnb2 (3 x 68 rows a K4 call of its solves)
NB_FLEET = 953            # query chunk rows of fleet_lattice (K3's rows a member)
R_PAST_CAP = 70000        # rows of the K1-K3 launches past CUDA's gridDim.y cap of 65535
# the card's float32 against the CPU's float64 at the cross-check sizes: 10x the
# CPU's own float32-against-float64 differences there
TOL64_MT_DNB2 = {"coeffs": 3e-4, "logdet": 1e-4, "mll": 1e-4, "post_mean": 1e-4,
                 "post_var": 3e-4, "post_cov": 2e-4, "cubature_cov": 3e-5}
TOL64_MT_LATTICE = {"coeffs": 2e-4, "logdet": 1e-5, "mll": 1e-5, "post_mean": 1e-4,
                    "post_var": 5e-5, "post_cov": 5e-5, "cubature_cov": 5e-5}


def _mt_y(xs):
    """bench.py's function, fidelity l shifted by 0.1 l cos(2 pi x_2)."""
    return [_f(x) + 0.1 * l * np.cos(2 * np.pi * x[:, 2]) for l, x in enumerate(xs)]


def _deriv_y(xs):
    """bench.py:make_lattice_grad's data: sin(2 pi x_0) and its gradient."""
    return [np.sin(2 * np.pi * xs[0][:, 0])] + [
        2 * np.pi * np.cos(2 * np.pi * x[:, 0]) * (j == 0) for j, x in enumerate(xs[1:])]


def _seeded_raw(gp, seed=7):
    """The model's raw hyperparameters with the noise at 1e-8 and, from a
    seed, the lengthscales and (where it is trained) the task kernel."""
    rng = np.random.default_rng(seed)
    raw = {k: p.raw.detach().cpu().double().numpy() for k, p in gp.params.items()}
    raw["lengthscales"] = rng.uniform(-0.5, 0.5, raw["lengthscales"].shape)
    raw["noise"] = np.full(raw["noise"].shape, math.log(1e-8))
    if gp.params["factor_task_kernel"].trainable:
        raw["factor_task_kernel"] = rng.uniform(0.5, 1.5, raw["factor_task_kernel"].shape)
        raw["noise_task_kernel"] = np.log(rng.uniform(0.05, 0.2, raw["noise_task_kernel"].shape))
    return raw


def mt_model(torch, ft, cls, ns, dtype=None, device=None):
    """``examples/multitask.py``'s multi-fidelity setup at d = 8: one task a
    fidelity, n_l points each."""
    T = len(ns)
    gp = cls(D, num_tasks=T, seed_for_seq=7, alpha=2, dtype=dtype, device=device)
    tasks = list(range(T))
    xs = gp.get_x_next_host(list(ns), task=tasks)
    gp.add_y_next([torch.as_tensor(y) for y in _mt_y(xs)], task=tasks)
    ft.load_jax_params(gp, _seeded_raw(gp))
    return gp


def deriv_model(torch, ft, n, dtype=None, device=None):
    """``bench.py:make_lattice_grad`` on the digital net: (f, grad f) as 4
    tasks at d = 3, alpha = 3, n points each (M = 4).  Its blocks are nearly
    singular (the task kernel is pinned to all ones and adds no noise), so in
    float32 the eigenvalue floor and the ridge decide the small eigenvalues:
    float32 does not resolve this system, in the JAX package as in the port
    (``tests/test_torch_derivatives_fleet.py::
    test_grad_informed_dnb2_float32_unresolved_in_both_packages``: at n =
    2^12 the JAX package's float32 coefficients are 0.83 of the max off its
    float64 ones).  Phase 6 serves it in float64, the path the cross-check
    holds."""
    d = 3
    derivs = [np.zeros((1, d), dtype=np.int64)] + [e[None, :] for e in np.eye(d, dtype=np.int64)]
    gp = ft.FastGPDigitalNetB2(d, num_tasks=d + 1, seed_for_seq=7, alpha=3, derivatives=derivs,
                               dtype=dtype, device=device)
    tasks = list(range(d + 1))
    xs = gp.get_x_next_host([n] * (d + 1), task=tasks)
    gp.add_y_next([torch.as_tensor(y) for y in _deriv_y(xs)], task=tasks)
    ft.load_jax_params(gp, _seeded_raw(gp))
    return gp


def fleet_model(torch, ft, n, dtype=None, device=None):
    """A fleet of 8 lattice GPs over shared points (``examples/batch_multitask.py``'s
    shape_batch), each with its own lengthscales and scale; member b observes
    (b + 1) f."""
    B = B_FLEET
    gp = ft.FastGPLattice(D, seed_for_seq=7, alpha=2, shape_batch=(B,), shape_lengthscales=(B, D),
                          shape_scale=(B, 1), dtype=dtype, device=device)
    y = _f(gp.get_x_next_host(n))
    gp.add_y_next(torch.as_tensor(np.stack([(b + 1) * y for b in range(B)])))
    ft.load_jax_params(gp, _seeded_raw(gp))
    return gp


def _counts(counters):
    return {k: v for c in counters for k, v in c.launches.items()}


def _finite(torch, name, out):
    for t in (out if isinstance(out, tuple) else (out,)):
        if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite output")


def cuda_profile(torch, fn, top=0):
    """Device ms and kernel launches of ``fn()`` under ``torch.profiler``
    with CUDA activity only (a request launches ~10^5 kernels, and the CPU
    side's events would cost the profile's parse a minute); with ``top``,
    also the ``top`` kernels by device time as (ms, launches, name)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if not top:
        return device_events(prof)
    evs = sorted(((dev_us(e) / 1e3, e.count, e.key) for e in prof.key_averages()
                  if dev_us(e) > 0), reverse=True)
    return device_events(prof) + (evs[:top],)


def step_profile(torch, gp, d_out, steps=8):
    """The fit step (loss, gradient, Rprop update) of ``gp``'s MLL: wall ms a
    step over a chain of 2 x ``steps`` (``steps`` a dispatch), then the device
    ms and kernel launches a step of a chain of ``steps`` under the profiler,
    and the device's busy share of the unprofiled step."""
    const = d_out * float(gp.n.sum()) * math.log(2 * math.pi)
    lg = gp._make_loss_fn("MLL", None, d_out, const, 1)
    data = gp._fit_data()
    fit_chain(torch, gp, lg, data, steps, steps)
    t0 = time.perf_counter()
    fit_chain(torch, gp, lg, data, 2 * steps, steps)
    step_ms = (time.perf_counter() - t0) / (2 * steps) * 1e3
    dev_ms, nlaunch, top = cuda_profile(
        torch, lambda: fit_chain(torch, gp, lg, data, steps, steps), top=5)
    return dict(step_ms=step_ms, device_ms=dev_ms / steps, launches=nlaunch / steps,
                busy=dev_ms / steps / step_ms,
                top=[(ms / steps, c / steps, name[:90]) for ms, c, name in top])


def call_profile(torch, fn):
    """Wall ms of one call, then its device ms and kernel launches under the
    profiler, and the device's busy share of the unprofiled wall time."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev_ms, nlaunch = cuda_profile(torch, fn)
    return dict(wall_ms=wall, device_ms=dev_ms, launches=nlaunch, busy=dev_ms / wall)


def phase_config(torch, tp, tf, label, gp, fits, serve, fit_kernels, serve_kernels, profiled,
                 d_out=1):
    """One configuration of phase 6 on the card, the plain versions of K1, K2
    and K4 refused: ``fits`` (``fit`` keyword sets, run in turn, each with
    the launch counters reset just before and read just after; the kernels
    ``fit_kernels`` must have launched in each), then the requests ``serve``
    ((name, call) pairs; their launch counts together, ``serve_kernels``
    must have launched), each call's wall time; the profiles of the fit step
    and of the request ``profiled`` ((name, call)); peak device memory."""
    sync = torch.cuda.synchronize
    counters = (tp, tf)
    res = {"fits": [], "serve_ms": {}}
    torch.cuda.reset_peak_memory_stats()
    with refuse_plain(tp, tf):
        for kw in fits:
            before = {k: p.raw.clone() for k, p in gp.params.items()}
            for c in counters:
                c.reset_launches()
            t0 = time.perf_counter()
            out = gp.fit(verbose=0, store_loss_hist=True, **kw)
            sync()
            wall = time.perf_counter() - t0
            counts = _counts(counters)
            lh = out["loss_hist"]
            shown = {k: v for k, v in kw.items() if k != "masks"}
            if "masks" in kw:
                shown["masks"] = np.asarray(kw["masks"]).tolist()
            log(f"  fit({shown}): {wall:.3f} s, {out['iterations']} iterations, loss "
                f"{lh[0]:.6e} -> {lh[-1]:.6e}; launches {counts}")
            if not np.isfinite(lh).all():
                raise AssertionError(f"{label}: non-finite loss in the fit")
            moved = [k for k, p in gp.params.items() if not torch.equal(p.raw, before[k])]
            if not moved or any(not gp.params[k].trainable for k in moved):
                raise AssertionError(f"{label}: the fit moved {moved}")
            if "masks" in kw:
                keep = np.setdiff1d(np.arange(B_FLEET), np.asarray(kw["masks"]).ravel())
                ls0, ls1 = before["lengthscales"], gp.params["lengthscales"].raw
                if not torch.equal(ls0[keep], ls1[keep]) or torch.equal(ls0, ls1):
                    raise AssertionError(f"{label}: the masked fit moved unmasked members")
            if not all(counts[k] > 0 for k in fit_kernels):
                raise AssertionError(f"{label}: a kernel of the fit never launched: {counts}")
            res["fits"].append(dict(wall_s=wall, iterations=out["iterations"],
                                    loss=[float(lh[0]), float(lh[-1])], launches=counts))
        for c in counters:
            c.reset_launches()
        outs = {}
        for name, call in serve:
            t0 = time.perf_counter()
            outs[name] = call()
            sync()
            res["serve_ms"][name] = (time.perf_counter() - t0) * 1e3
            _finite(torch, name, outs[name])
        res["serve_launches"] = _counts(counters)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if not all(res["serve_launches"][k] > 0 for k in serve_kernels):
            raise AssertionError(f"{label}: a kernel of serving never launched: "
                                 f"{res['serve_launches']}")
        res["step"] = step_profile(torch, gp, d_out)
        res["serve_profile"] = dict(call_profile(torch, profiled[1]), request=profiled[0])
    log("  requests: " + ", ".join(f"{k} {v:.1f} ms" for k, v in res["serve_ms"].items())
        + f"; launches {res['serve_launches']}; peak device memory {res['peak_gib']:.2f} GiB")
    st, sp = res["step"], res["serve_profile"]
    log(f"  fit step: {st['step_ms']:.2f} ms a step, device busy {st['device_ms']:.3f} ms "
        f"({100 * st['busy']:.1f}%), {st['launches']:.0f} device launches a step; its largest:")
    for ms, c, name in st["top"]:
        log(f"    {ms:9.4f} ms  x{c:<7.1f} {name}")
    log(f"  {profiled[0]}: wall {sp['wall_ms']:.1f} ms, device busy {sp['device_ms']:.1f} ms "
        f"({100 * sp['busy']:.1f}%), {sp['launches']} device launches")
    return res, outs


def check_mt_outputs(torch, gp, outs, nq, with_cov):
    """Shapes and consistency of mt_dnb2 / mt_lattice's answers: variances
    non-negative, the credible interval around its mean, the cubature
    covariance's diagonal the cubature variances; with ``with_cov`` the
    posterior covariance of the first 256 query points with themselves,
    whose (t, t) diagonals are the variances ``post_mean_var`` served there
    (within 1e-3 of the prior variance: two float32 paths through
    cancellation)."""
    T = gp.num_tasks
    pm, pv = outs["post_mean_var"]
    if pm.shape != (T, nq) or pv.shape != (T, nq) or bool((pv < 0).any()):
        raise AssertionError("post_mean_var: wrong shape or negative variance")
    pmc, pvc, q, lo, hi = outs["post_ci"]
    if pmc.shape != (256,) or not bool(((lo <= pmc) & (pmc <= hi)).all()):
        raise AssertionError("post_ci: wrong shape or interval")
    pcc = outs["post_cubature_cov"]
    pcv = gp.post_cubature_var(task=list(range(T)))
    if pcc.shape != (T, T) or not torch.allclose(torch.diagonal(pcc), pcv, rtol=1e-6, atol=0):
        raise AssertionError("post_cubature_cov: wrong shape or diagonal")
    if with_cov:
        pc = outs["post_cov"]
        if pc.shape != (T, T, 256, 256):
            raise AssertionError("post_cov: wrong shape")
        prior = float((gp.scale * torch.diagonal(gp.gram_matrix_tasks)).max())
        gap = max(float((torch.diagonal(pc[t, t]) - pv[t, :256]).abs().max()) for t in range(T))
        log(f"  post_cov diagonal vs post_mean_var's variance: max abs {gap:.2e} "
            f"(tol {1e-3 * prior:.1e}, 1e-3 of the prior variance)")
        if not gap < 1e-3 * prior:
            raise AssertionError("post_cov: diagonal disagrees with the variance")


def fleet_var_routes(torch, tp, tf, gp, xq, reps=2):
    """A fleet's posterior variances on the permuted path two ways, in one
    call, the plain kernel versions refused: "k3", the package's route (K3
    once a member, each with its own weights), against "k1", the JAX
    package's route for a batched spectrum (K1 over every member's rows,
    then the weighted sum of |spectrum|^2 in torch ops).  First the
    variance step alone on one query chunk's rows (CUDA graphs; the two
    results held against each other at 1e-5 of the max), then the whole
    ``post_mean_var`` of ``xq`` in the order k3, k1, k1, k3 (``reps`` = 2
    of each), with launches and peak memory."""
    from fastgaussianprocesses_torch.models import fast as fm
    cls = fm._PermSpectrumSolver
    k3_route = cls.gram_quad_diag

    def k1_route(self, ycat, extra_ndim=0, pre_permuted=False):
        yst = self.model._ft_perm_q(ycat, pre_permuted)
        zt = yst / self._lam_b(extra_ndim)
        return torch.real(torch.conj(yst) * zt).sum(-1)

    seen = []

    def capture(self, ycat, extra_ndim=0, pre_permuted=False):
        seen.append((self, ycat, extra_ndim, pre_permuted))
        return k3_route(self, ycat, extra_ndim, pre_permuted)
    routes = {"k3": k3_route, "k1": k1_route}
    res = {"request_ms": {"k3": [], "k1": []}, "launches": {}, "peak_gib": {}}
    with refuse_plain(tp, tf):
        cls.gram_quad_diag = capture
        try:
            gp.post_mean_var(xq[:NB_FLEET])
        finally:
            cls.gram_quad_diag = k3_route
        solver, ycat, extra, pre = seen[0]
        if not pre:
            raise AssertionError("fleet routes: the chunk's rows were not pre-permuted")
        outs = {k: f(solver, ycat, extra, pre) for k, f in routes.items()}
        err = rel_err(outs["k1"], outs["k3"])[0]
        res["step_ms"] = {k: gtime(lambda f=f: f(solver, ycat, extra, pre), 5)
                          for k, f in routes.items()}
        res["step_shape"], res["step_err"] = list(outs["k3"].shape), err
        del outs, seen, solver, ycat
        torch.cuda.empty_cache()
        try:
            for k in ("k3", "k1", "k1", "k3") * (reps // 2):
                cls.gram_quad_diag = routes[k]
                tp.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                gp.post_mean_var(xq)
                torch.cuda.synchronize()
                res["request_ms"][k].append((time.perf_counter() - t0) * 1e3)
                res["launches"][k] = dict(tp.launches)
                res["peak_gib"][k] = torch.cuda.max_memory_allocated() / 2**30
        finally:
            cls.gram_quad_diag = k3_route
    log(f"  fleet variance routes, one chunk's step (output {res['step_shape']}, rows of "
        f"n = 2^16): k3 {res['step_ms']['k3']:.4f} ms, k1 {res['step_ms']['k1']:.4f} ms; "
        f"k1 vs k3 {err:.2e} (tol 1e-5)")
    log(f"  fleet post_mean_var of {len(xq)} points: k3 "
        + ", ".join(f"{v:.1f}" for v in res["request_ms"]["k3"]) + " ms, k1 "
        + ", ".join(f"{v:.1f}" for v in res["request_ms"]["k1"])
        + f" ms; launches {res['launches']}; peak {res['peak_gib']} GiB")
    if not err < 1e-5:
        raise AssertionError("fleet variance routes disagree")
    return res


def check_row_cap(torch, tp):
    """K1, K2 and K3 at n = 2^14 on R = 70 000 rows, past CUDA's gridDim.y
    cap of 65535.  Through the public ops ``pfft``, ``pifft_real`` and
    ``pfft_quad``: two launches each (row blocks), and rows 0-999 and
    65 000-69 999 (both sides of the block boundary) against the plain
    versions at phase 3's tolerance (``pfft_quad`` against its definition
    on ``pfft_plain``'s spectrum).  Then through the wrappers' ``out`` test
    hook, the outputs filled with NaN first: every row written (no NaN
    left)."""
    n, R = 1 << 14, R_PAST_CAP
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(R, n, device="cuda", generator=g) + 1.0
    w = torch.rand(n, device="cuda", generator=g) + 0.1
    rows = torch.cat([torch.arange(0, 1000), torch.arange(65000, R)]).cuda()
    tp.reset_launches()
    t0 = time.perf_counter()
    X = tp.pfft(x, n)
    xb = tp.pifft_real(X, n)
    q = tp.pfft_quad(x, w, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(tp.launches)
    xs = x[rows]
    m = xs.mean(-1)
    e1 = rel_err(X[rows], tp.pfft_plain(xs, n))[0]
    e2 = rel_err(xb[rows], tp.pifft_real_plain(X[rows], n))[0]
    spec = tp.pfft_plain(xs - m[:, None], n)
    e3 = rel_err(q[rows], (w * spec.abs().square()).sum(-1) / n + w[0] * n * m * m)[0]
    del X, xb, q, xs, spec
    torch.cuda.empty_cache()
    # the test hook: caller-owned outputs, NaN-filled, so that a row block
    # left unwritten shows
    tp.reset_launches()
    A0, Bh, Bl, _ = tp._plan(n)
    wk = torch.rand(Bh, A0, Bl, device="cuda", generator=g) + 0.1
    X = torch.full((R, n), complex(math.nan, math.nan), dtype=torch.complex64, device="cuda")
    tp._pfft_cuda(x, n, out=X)
    xb = torch.full((R, n), math.nan, dtype=torch.float32, device="cuda")
    tp._pifft_real_cuda(X, n, out=xb)
    H = tp._slab_plan(n)[0] // 2 + 1
    part = torch.full((R, H), math.nan, dtype=torch.float32, device="cuda")
    tp.quad_partials(x, wk, n, x.mean(-1), out=part)
    torch.cuda.synchronize()
    counts_out = dict(tp.launches)
    unwritten = [int(torch.isnan(torch.view_as_real(t) if t.is_complex() else t)
                     .flatten(1).any(-1).sum()) for t in (X, xb, part)]
    log(f"  K1-K3 at n=2^14, R={R}, public ops ({wall:.2f} s, launches {counts}): rows "
        f"0-999 and 65000-{R - 1} vs plain: K1 {e1:.3e}, K2 {e2:.3e}, K3 {e3:.3e} (tol "
        f"{TOL_KERNEL:.0e}); into NaN-filled outputs (launches {counts_out}): rows left "
        f"unwritten {unwritten}")
    del x, X, xb, part
    torch.cuda.empty_cache()
    if any(unwritten) or not max(e1, e2, e3) < TOL_KERNEL:
        raise AssertionError("K1-K3 past the row cap: rows unwritten or wrong")
    two = {"pfft": 2, "pifft_real": 2, "pifft": 0, "quad": 2}
    if counts != two or counts_out != two:
        raise AssertionError(f"K1-K3 past the row cap: launches {counts}, {counts_out}, "
                             "not two row blocks")


CROSS_RUNS = {"card f32": ("cuda", "float32"), "cpu f32": ("cpu", "float32"),
              "cpu f64": ("cpu", "float64"), "card f64": ("cuda", "float64")}


def cross_results(torch, tp, tf, build, run):
    """One run of a cross-check: ``build(dtype, device)``'s coefficients,
    log-determinant, MLL, ``post_mean_var`` (64 points, every task),
    ``post_cov`` (16 x 16), ``post_cubature_cov`` and its prior variance, and
    the MLL's gradient; on the card with the plain kernel versions refused."""
    from contextlib import nullcontext
    dev, dt = CROSS_RUNS[run]
    gp = build(getattr(torch, dt), dev)
    xq = np.random.default_rng(5).uniform(size=(64, gp.d))
    lg = gp._make_loss_fn("MLL", None, 1, float(gp.n.sum()) * math.log(2 * math.pi), 1)
    with refuse_plain(tp, tf) if dev == "cuda" else nullcontext():
        loss, _, g = lg(gp._raw_dict(), gp._fit_data())
        pm, pv = gp.post_mean_var(xq)
        out = {"coeffs": gp.coeffs, "logdet": gp._solver().factor.logdet, "mll": loss,
               "post_mean": pm, "post_var": pv, "post_cov": gp.post_cov(xq[:16], xq[:16]),
               "cubature_cov": gp.post_cubature_cov()}
    res = {k: v.detach().double().cpu().reshape(-1) for k, v in out.items()}
    res["prior"] = float((gp.scale * torch.diagonal(gp.gram_matrix_tasks)).abs().max())
    return res, {k: g[k].double().cpu().numpy() for k in g if gp.params[k].trainable}


def cross_errors(a, b):
    """Max |a - b| of each quantity over the max |b|, the cubature
    covariance's over its prior variance (it is the prior minus an O(prior)
    term)."""
    return {k: float((a[k] - b[k]).abs().max()) / (b["prior"] if k == "cubature_cov" else
                                                   float(b[k].abs().max()))
            for k in a if k != "prior"}


def grad_signs_agree(ga, gb):
    """Entries above 1e-3 of their parameter's largest agree in sign."""
    return all((np.sign(ga[k][big]) == np.sign(gb[k][big])).all()
               for k in gb for big in [np.abs(gb[k]) > 1e-3 * np.abs(gb[k]).max()])


def mt_crosscheck(torch, tp, tf, label, build, holds):
    """Small-size cross-check of one configuration.  ``holds``: (run, ref,
    limit) triples over ``CROSS_RUNS``, the limit a number, a {quantity:
    limit} dict, or None (printed, not held); where held, the MLL gradient's
    signs must agree too."""
    runs = {r for h in holds for r in h[:2]}
    res = {r: cross_results(torch, tp, tf, build, r) for r in sorted(runs)}
    failed = []
    for run, ref, lim in holds:
        errs = cross_errors(res[run][0], res[ref][0])
        signs = grad_signs_agree(res[run][1], res[ref][1])
        lims = {k: lim.get(k) if isinstance(lim, dict) else lim for k in errs}
        log(f"  {label} {run} vs {ref}: " + ", ".join(
            f"{k} {e:.2e}" + ("" if lims[k] is None else f" (tol {lims[k]:.0e})")
            for k, e in errs.items()) + f"; gradient signs agree: {signs}"
            + ("" if lim is not None else " (printed, not held)"))
        if lim is not None and (not signs or not all(errs[k] < lims[k] for k in errs)):
            failed.append(f"{run} vs {ref}")
    if failed:
        raise AssertionError(f"{label}: {', '.join(failed)} disagree")


def phase_multitask(torch, ft, tp, tf):
    """Phase 6: the multitask, derivative-informed and fleet models on the
    card (see the module docstring); returns their results for the kernels
    line and the ``{"multitask": ...}`` line."""
    out = {}
    tasks = [0, 1, 2]
    rng = np.random.default_rng(11)
    xq = rng.uniform(size=(4096, D))
    x256 = xq[:256]

    def profiled(gp):       # a quarter of the served post_mean_var
        return "post_mean_var (256 points, every task)", lambda: gp.post_mean_var(x256, task=tasks)
    log("  mt_dnb2: FastGPDigitalNetB2(d=8, num_tasks=3), n = (2^20, 2^19, 2^18), M = 7")
    t0 = time.perf_counter()
    gp = mt_model(torch, ft, ft.FastGPDigitalNetB2, MT_NS)
    torch.cuda.synchronize()
    log(f"  setup (points, data, params): {time.perf_counter() - t0:.2f} s; query chunk "
        f"{gp._query_chunk_size(1024, sum(MT_NS))} rows")
    if gp._query_chunk_size(1024, sum(MT_NS)) != NB_MT:
        raise AssertionError(f"mt_dnb2's query chunk is not {NB_MT} rows")
    serve = [("post_mean_var", lambda: gp.post_mean_var(xq[:1024], task=tasks)),
             ("post_cov", lambda: gp.post_cov(x256, x256, task0=tasks, task1=tasks)),
             ("post_ci", lambda: gp.post_ci(x256, task=2)),
             ("post_cubature_cov", gp.post_cubature_cov)]
    res, outs = phase_config(torch, tp, tf, "mt_dnb2", gp, [dict(iterations=20)], serve,
                             ("fwht",), ("fwht",), profiled(gp))
    if type(gp._solver()).__name__ != "_FastSolver" or gp._solver().factor.inv.shape[-1] != 7:
        raise AssertionError("mt_dnb2 did not take the M = 7 multitask solver")
    check_mt_outputs(torch, gp, outs, 1024, with_cov=True)
    out["mt_dnb2"] = res
    del gp, outs, serve
    torch.cuda.empty_cache()

    log("  mt_lattice: FastGPLattice(d=8, num_tasks=3), n = (2^20, 2^19, 2^18), M = 7 "
        "(torch.fft)")
    gp = mt_model(torch, ft, ft.FastGPLattice, MT_NS)
    serve = [("post_mean_var", lambda: gp.post_mean_var(xq[:1024], task=tasks)),
             ("post_ci", lambda: gp.post_ci(x256, task=2)),
             ("post_cubature_cov", gp.post_cubature_cov)]
    res, outs = phase_config(torch, tp, tf, "mt_lattice", gp, [dict(iterations=20)], serve, (), (),
                             profiled(gp))
    check_mt_outputs(torch, gp, outs, 1024, with_cov=False)
    out["mt_lattice"] = res
    del gp, outs, serve
    torch.cuda.empty_cache()

    log("  deriv_dnb2: FastGPDigitalNetB2(d=3, alpha=3, num_tasks=4, derivatives=[0, e0, e1, "
        "e2]), n = 2^16 a task, M = 4, float64 (float32 does not resolve it)")
    gp = deriv_model(torch, ft, N_DERIV, torch.float64)
    xd = rng.uniform(size=(1024, 3))
    serve = [("post_mean", lambda: gp.post_mean(xd, task=[0, 1, 2, 3]))]
    res, outs = phase_config(torch, tp, tf, "deriv_dnb2", gp, [dict(iterations=20)], serve,
                             ("fwht",), ("fwht",),
                             ("post_mean (256 points)",
                              lambda: gp.post_mean(xd[:256], task=[0, 1, 2, 3])))
    pm = outs["post_mean"]
    f = torch.sin(2 * math.pi * torch.as_tensor(xd[:, 0]))
    rms = float((pm[0].double().cpu() - f).square().mean().sqrt() / f.square().mean().sqrt())
    log(f"  deriv_dnb2 post_mean of f against sin(2 pi x_0): rms error {rms:.3e} of its rms "
        f"(float64; printed, not held: the model's own error, not the port's)")
    if pm.shape != (4, 1024):
        raise AssertionError("deriv_dnb2: post_mean has the wrong shape")
    out["deriv_dnb2"] = res
    del gp, outs, serve
    torch.cuda.empty_cache()

    log("  fleet_lattice: FastGPLattice(d=8, shape_batch=(8,)), n = 2^16, member b observes "
        "(b+1) f")
    gp = fleet_model(torch, ft, N_FLEET)
    if gp._query_chunk_size(4096, N_FLEET) != NB_FLEET:
        raise AssertionError(f"fleet_lattice's query chunk is not {NB_FLEET} rows")
    serve = [("post_mean_var", lambda: gp.post_mean_var(xq))]
    res, outs = phase_config(torch, tp, tf, "fleet_lattice", gp,
                             [dict(iterations=10), dict(iterations=4, masks=np.array([[1, 5]]))],
                             serve, ("pfft", "pifft_real"), ("pifft_real", "quad"), serve[0],
                             d_out=B_FLEET)
    if type(gp._solver()).__name__ != "_PermSpectrumSolver":
        raise AssertionError("fleet_lattice did not take the float32 permuted path")
    pm, pv = outs["post_mean_var"]
    if pm.shape != (B_FLEET, 4096) or pv.shape != (B_FLEET, 4096) or bool((pv < 0).any()):
        raise AssertionError("fleet_lattice post_mean_var: wrong shape or negative variance")
    res["var_routes"] = fleet_var_routes(torch, tp, tf, gp, xq)
    out["fleet_lattice"] = res
    del gp, outs, serve
    torch.cuda.empty_cache()

    log("  K1-K3 past the row cap")
    check_row_cap(torch, tp)
    log("  cross-checks at n = (2^12, 2^11, 2^10), d = 8 (mt) and n = 2^12, d = 3 (deriv)")
    small = (1 << 12, 1 << 11, 1 << 10)
    mt_crosscheck(torch, tp, tf, "mt_dnb2",
                  lambda dt, dev: mt_model(torch, ft, ft.FastGPDigitalNetB2, small, dt, dev),
                  (("card f32", "cpu f32", 5e-5), ("card f32", "cpu f64", TOL64_MT_DNB2)))
    mt_crosscheck(torch, tp, tf, "mt_lattice",
                  lambda dt, dev: mt_model(torch, ft, ft.FastGPLattice, small, dt, dev),
                  (("card f32", "cpu f32", 5e-5), ("card f32", "cpu f64", TOL64_MT_LATTICE)))
    # float32 does not resolve the derivative-informed system in either package
    # (see deriv_model): the card's float64 path, the one phase 6 serves, is
    # held; its float32 is printed
    mt_crosscheck(torch, tp, tf, "deriv_dnb2",
                  lambda dt, dev: deriv_model(torch, ft, 1 << 12, dt, dev),
                  (("card f64", "cpu f64", 1e-6), ("card f32", "cpu f32", None),
                   ("card f32", "cpu f64", None)))
    return out



# ---- phase 7: the HMC hyperposterior, StandardGP and the examples -----------------------

N_HMC, D_HMC, C_HMC = 1 << 14, 4, 8   # bench.py:bench_hmc's model, its 8 chains
N_STD = 1 << 13                       # StandardGP: a 20-step fit near a second
# the kernels an HMC gradient launches once, on all chains' rows
HMC_GRAD_KERNELS = {"lattice": {"pfft": 1, "pifft_real": 1}, "dnb2": {"fwht": 2}}


class row_spy:
    """Within the block, record the rows of every K1, K2 and K4 launch (the
    wrappers' launch counters are untouched)."""

    def __init__(self, tp, tf):
        self.mods = ((tp, "_pfft_cuda", "pfft"), (tp, "_pifft_real_cuda", "pifft_real"),
                     (tf, "_fwht_cuda", "fwht"))
        self.rows = {}

    def __enter__(self):
        self.saved = [getattr(m, k) for m, k, _ in self.mods]
        for (m, k, name), f in zip(self.mods, self.saved):
            def spy(x, *a, _f=f, _name=name, **kw):
                self.rows.setdefault(_name, set()).add(x.numel() // x.shape[-1])
                return _f(x, *a, **kw)
            setattr(m, k, spy)
        return self

    def __exit__(self, *exc):
        for (m, k, _), f in zip(self.mods, self.saved):
            setattr(m, k, f)


def phase_hmc(torch, tp, tf, label, gp, kind, kw):
    """One HMC cell on the card with the plain kernel versions refused:
    ``sample_gp_hyperposterior(gp, **kw)`` with the launch counters reset
    just before and read just after; every gradient must launch the kernels
    of ``HMC_GRAD_KERNELS[kind]`` once (K4 twice), each on all chains' rows,
    and every log-density be finite.  Then 6 iterations of the same sampler
    profiled (device busy share, launches and device time a gradient)."""
    from fastgaussianprocesses_torch.fit import hmc as th
    sync = torch.cuda.synchronize
    chains = kw["num_chains"]
    gp._warm_for_fit()   # the observations' transform is the fit's data, not a gradient's
    sync()
    torch.cuda.reset_peak_memory_stats()
    with refuse_plain(tp, tf), row_spy(tp, tf) as spy:
        for c in (tp, tf):
            c.reset_launches()
        t0 = time.perf_counter()
        res, diags = th.sample_gp_hyperposterior(gp, **kw)
        sync()
        wall = time.perf_counter() - t0
        counts = _counts((tp, tf))
    lp = res.log_prob
    grads = res.num_grad_evals
    iters = kw["num_warmup"] + kw["num_samples"]
    out = dict(wall_s=wall, samples_per_s=kw["num_samples"] * chains / wall,
               accept=float(res.accept_rate), step_size=float(res.step_size),
               mean_leapfrog=res.mean_leapfrog, rhat=max(d["rhat"] for d in diags.values()),
               ess=min(d["ess"] for d in diags.values()), grad_evals=grads,
               grad_evals_yardstick=iters * (2 * res.mean_leapfrog + 2),
               launches=counts, rows={k: sorted(v) for k, v in spy.rows.items()},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {label}: {wall:.2f} s for {iters} iterations x {chains} chains, "
        f"{out['samples_per_s']:.2f} samples/s (num_samples * chains / wall, warmup included); "
        f"accept {out['accept']:.3f}, step size {out['step_size']:.4g}, mean leapfrog "
        f"{out['mean_leapfrog']:.2f}, worst R-hat {out['rhat']:.4f}, least ESS {out['ess']:.1f}; "
        f"gradient evaluations {grads} (the JAX package's 2 L + 2 an iteration: "
        f"{out['grad_evals_yardstick']:.0f}); launches {counts}, rows {out['rows']}; "
        f"peak {out['peak_gib']:.2f} GiB")
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{label}: non-finite log_prob")
    for k, per in HMC_GRAD_KERNELS[kind].items():
        if counts[k] != per * grads or out["rows"].get(k) != [chains]:
            raise AssertionError(f"{label}: {k} launched {counts[k]} times on rows "
                                 f"{out['rows'].get(k)} for {grads} gradients of {chains} chains")
    logprob, init = th.gp_log_density(gp)
    short = dict(num_warmup=3, num_samples=3, num_chains=chains, mass_matrix="dense",
                 trajectory_adapt="chees", target_accept=0.8,
                 max_leapfrog=kw.get("max_leapfrog"))
    n_short = []

    def run():
        n_short.append(th.hmc(logprob, init, 1, **short).num_grad_evals)
    with refuse_plain(tp, tf):
        prof = call_profile(torch, run)
    g = n_short[-1]
    out["profile"] = dict(prof, grad_evals=g, device_ms_a_grad=prof["device_ms"] / g,
                          launches_a_grad=prof["launches"] / g,
                          wall_ms_a_grad=prof["wall_ms"] / n_short[0])
    log(f"  {label} profiled (6 iterations, {g} gradients): wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['device_ms']:.1f} ms ({100 * prof['busy']:.1f}%), {prof['launches']} "
        f"launches; a gradient: {out['profile']['device_ms_a_grad']:.3f} ms of device time, "
        f"{out['profile']['launches_a_grad']:.0f} launches")
    return out


def hmc_crosscheck(torch, ft, tp, tf):
    """The sampler on the card against the CPU on the same draws (lattice,
    n = 2^8, d = 2, float64, 4 chains, 10 iterations): samples, log-densities
    and the final positions within 1e-8 relative.  The model has noise 1.0:
    the two FFTs round differently, and at the default noise (1e-8) the
    smallest eigenvalues carry ~1e-6 relative rounding into the gradient,
    which the trajectories and dual averaging amplify (on the CPU, scaling
    the positions by 1 + 1e-15 moves log_prob by 5.7e-5 after 10 iterations
    at noise 1e-8, by 2.9e-12 at noise 1.0).  Then each chain's
    log-density and gradient at 8 fixed raw points (n = 2^14, d = 4, noise
    1.0 as phase 5's gradient check, so that float32's eigenvalue floor does
    not decide the surface): the card's float32 against the CPU's float32
    plain kernels (value 5e-5, phase 4's card-against-CPU float32 tolerance)
    and the CPU's float64 evaluated with float32's floor (2e-4, phase 5's),
    every gradient entry above 1e-3 of its parameter's largest agreeing in
    sign with each."""
    from fastgaussianprocesses_torch.fit import hmc as th
    from fastgaussianprocesses_torch.linalg import fast_solver as fs
    runs = {}
    for dev in ("cpu", "cuda"):
        gp = fit_model(torch, ft.FastGPLattice, 1 << 8, d=2, dtype=torch.float64, device=dev,
                       noise=1.0)
        logprob, init = th.gp_log_density(gp)
        with refuse_plain(tp, tf) if dev == "cuda" else contextlib.nullcontext():
            runs[dev] = th.hmc(logprob, init, 5, num_warmup=5, num_samples=5, num_chains=4,
                               mass_matrix="dense", trajectory_adapt="chees", target_accept=0.9)
    a, b = runs["cuda"], runs["cpu"]
    errs = {"log_prob": rel_err(a.log_prob, b.log_prob)[0],
            "q": rel_err(a.state[0][0], b.state[0][0])[0]}
    errs.update({f"samples[{k}]": rel_err(a.samples[k], b.samples[k])[0] for k in a.samples})
    log("  sampler, card f64 vs cpu f64 on the same draws (10 iterations, 4 chains): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (tol 1e-8)")
    if not all(v < 1e-8 for v in errs.values()):
        raise AssertionError("HMC: the card's sampler and the CPU's disagree")
    rng = np.random.default_rng(8)
    res = {}
    floor_c = fs.EIG_FLOOR_C
    for label, dev, dt, fscale in (("card f32", "cuda", torch.float32, 1.0),
                                   ("cpu f32 (plain kernels)", "cpu", torch.float32, 1.0),
                                   ("cpu f64 (float32 floor)", "cpu", torch.float64,
                                    EPS32 / float(np.finfo(np.float64).eps))):
        gp = fit_model(torch, ft.FastGPLattice, N_HMC, d=D_HMC, dtype=dt, device=dev, noise=1.0)
        logprob, init = th.gp_log_density(gp)
        if not res:
            pts = {k: v.double().cpu().numpy()[None]
                   + 0.3 * rng.standard_normal((8,) + tuple(v.shape)) for k, v in init.items()}
        leaves = {k: torch.tensor(v, dtype=dt, device=gp.device, requires_grad=True)
                  for k, v in pts.items()}
        fs.EIG_FLOOR_C = floor_c * fscale
        try:
            with refuse_plain(tp, tf) if dev == "cuda" else contextlib.nullcontext():
                val = logprob(leaves)
                g = torch.autograd.grad(val.sum(), list(leaves.values()))
        finally:
            fs.EIG_FLOOR_C = floor_c
        res[label] = (val.detach().double().cpu().numpy(),
                      {k: t.double().cpu().numpy() for k, t in zip(leaves, g)})
    v0, g0 = res["card f32"]
    for ref, tol in (("cpu f32 (plain kernels)", 5e-5), ("cpu f64 (float32 floor)", 2e-4)):
        v1, g1 = res[ref]
        e = float(np.max(np.abs(v0 / v1 - 1)))
        signs = all((np.sign(g0[k][c][big]) == np.sign(g1[k][c][big])).all()
                    for k in g1 for c in range(8)
                    for big in [np.abs(g1[k][c]) > 1e-3 * np.abs(g1[k][c]).max()])
        log(f"  log-density of 8 chains, card f32 vs {ref}: max rel {e:.2e} (tol {tol:.0e}), "
            f"gradient signs agree: {signs}")
        if not (e < tol and signs):
            raise AssertionError(f"HMC log-density: card vs {ref}")


def phase_standard(torch, ft):
    """StandardGP on the card: n = 2^13, d = 8, float64 (fit, requests, peak
    memory), the same in float32 (printed against float64), a
    derivative-informed model (d = 3, 4 tasks at 2^9) and a model on Halton
    points (2^12)."""
    sync = torch.cuda.synchronize
    xq = np.random.default_rng(13).uniform(size=(4096, D))
    out = {}

    def std_model(n, dtype, device=None, d=D):
        gp = ft.StandardGP(d, seed_for_seq=7, dtype=dtype, device=device)
        gp.add_y_next(torch.as_tensor(_f(gp.get_x_next_host(n))))
        return gp

    def serve(gp, label):
        times, res = {}, {}
        for name, call in (("post_mean_var", lambda: gp.post_mean_var(xq)),
                           ("post_cubature_mean", gp.post_cubature_mean),
                           ("post_cubature_var", gp.post_cubature_var),
                           ("post_ci", lambda: gp.post_ci(xq[:256]))):
            t0 = time.perf_counter()
            res[name] = call()
            sync()
            times[name] = (time.perf_counter() - t0) * 1e3
            _finite(torch, f"{label} {name}", res[name])
        return times, res

    for dt in (torch.float64, torch.float32):
        label = f"StandardGP(8) n=2^13 {str(dt)[6:]}"
        gp = std_model(N_STD, dt)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fit = gp.fit(iterations=20, verbose=0, store_loss_hist=True)
        sync()
        fit_s = time.perf_counter() - t0
        times, res = serve(gp, label)
        step = step_profile(torch, gp, 1, steps=4)
        peak = torch.cuda.max_memory_allocated() / 2**30
        spd = float(gp._solver().spd_factor)
        out[str(dt)[6:]] = dict(fit_s=fit_s, step=step, serve_ms=times, peak_gib=peak,
                                spd_factor=spd, loss=[float(v) for v in fit["loss_hist"][[0, -1]]])
        log(f"  {label}: fit(iterations=20) {fit_s:.2f} s, loss {fit['loss_hist'][0]:.6e} -> "
            f"{fit['loss_hist'][-1]:.6e}; step {step['step_ms']:.2f} ms (device "
            f"{step['device_ms']:.2f} ms, {100 * step['busy']:.1f}% busy, {step['launches']:.0f} "
            f"launches); "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
            + f"; peak {peak:.2f} GiB; spd_factor {spd:g}")
        for ms, c, name in step["top"][:3]:
            log(f"    {ms:9.4f} ms  x{c:<5.1f} {name}")
        if not np.isfinite(fit["loss_hist"]).all():
            raise AssertionError(f"{label}: non-finite loss")
        if dt == torch.float64:
            ref = {k: (v[0] if isinstance(v, tuple) else v).double().cpu() for k, v in res.items()}
        else:
            got = {k: (v[0] if isinstance(v, tuple) else v).double().cpu() for k, v in res.items()}
            log("  float32 against float64 (printed, not held; the 64 eps trace floor and the "
                "nugget doubling decide float32 at this n): "
                + ", ".join(f"{k} {rel_err(got[k], ref[k])[0]:.2e}" for k in ref))
        del gp
        torch.cuda.empty_cache()
    # derivative-informed: (f, grad f) as 4 tasks, d = 3
    d3 = 3
    derivs = [np.zeros((1, d3), dtype=np.int64)] + [e[None, :] for e in np.eye(d3, dtype=np.int64)]
    gp = ft.StandardGP(d3, num_tasks=d3 + 1, seed_for_seq=7, derivatives=derivs)
    xs3 = gp.get_x_next_host([1 << 9] * (d3 + 1), task=list(range(d3 + 1)))
    gp.add_y_next([torch.as_tensor(y) for y in _deriv_y(xs3)], task=list(range(d3 + 1)))
    t0 = time.perf_counter()
    pm = gp.post_mean(xq[:256, :d3], task=list(range(d3 + 1)))
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    _finite(torch, "derivative-informed StandardGP", pm)
    f0 = torch.sin(2 * torch.pi * torch.as_tensor(xq[:256, 0]))
    err = float((pm[0].double().cpu() - f0).abs().max())
    log(f"  StandardGP(3) derivative-informed, 4 tasks at 2^9, {gp.dtype}: post_mean of 256 points "
        f"{ms:.1f} ms, max |mean - sin(2 pi x0)| {err:.2e}, spd_factor "
        f"{float(gp._solver().spd_factor):g}")
    out["deriv"] = dict(post_mean_ms=ms, err=err)
    gp = ft.StandardGP(ft.Halton(D, seed=7))
    gp.add_y_next(torch.as_tensor(_f(gp.get_x_next_host(1 << 12))))
    t0 = time.perf_counter()
    pm, pv = gp.post_mean_var(xq[:1024])
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    _finite(torch, "Halton StandardGP", (pm, pv))
    log(f"  StandardGP(Halton(8, seed=7)) n=2^12, {gp.dtype}: post_mean_var of 1024 points "
        f"{ms:.1f} ms")
    out["halton"] = dict(post_mean_var_ms=ms)
    return out


def standard_crosscheck(torch, ft):
    """StandardGP's float64 on the card against the CPU's at n = 2^10, d = 8,
    noise 1e-2 (``fit(iterations=20)``'s losses, ``post_mean_var`` of 64
    points and the cubature mean and variance): 1e-9 relative to each
    quantity's largest, variances to the prior variance they are subtracted
    from.  The two LAPACKs' Cholesky factors differ by ulps, which the
    Gram's condition number kappa amplifies to ~eps kappa: at the default
    noise (1e-4, kappa ~1e7) the variances were 1.26e-9 apart on an H100,
    at 1e-2 kappa is ~100 times smaller."""
    xs = np.random.default_rng(13).uniform(size=(64, D))
    runs = {}
    for dev in ("cpu", "cuda"):
        gp = ft.StandardGP(D, seed_for_seq=7, dtype=torch.float64, device=dev, noise=1e-2)
        gp.add_y_next(torch.as_tensor(_f(gp.get_x_next_host(1 << 10))))
        fit = gp.fit(iterations=20, verbose=0, store_loss_hist=True)
        pm, pv = gp.post_mean_var(xs)
        runs[dev] = dict(loss=torch.as_tensor(fit["loss_hist"]), post_mean=pm.cpu(),
                         post_var=pv.cpu(), cub_mean=gp.post_cubature_mean().cpu().reshape(1),
                         cub_var=gp.post_cubature_var().cpu().reshape(1),
                         prior=float(gp.scale[0]))
    a, b = runs["cuda"], runs["cpu"]
    errs = {k: rel_err(a[k], b[k])[0] for k in ("loss", "post_mean", "cub_mean")}
    errs.update({k: float((a[k] - b[k]).abs().max()) / b["prior"] for k in ("post_var", "cub_var")})
    log("  StandardGP n=2^10 float64, card vs cpu: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (tol 1e-9)")
    if not all(v < 1e-9 for v in errs.values()):
        raise AssertionError("StandardGP: the card's float64 and the CPU's disagree")


def phase_examples(torch, tp, tf):
    """The port's examples on the card at the JAX examples' sizes (their
    defaults), with the plain kernel versions refused."""
    import importlib
    out = {}
    with refuse_plain(tp, tf):
        for name in ("simple", "multitask", "batch_multitask", "derivative_informed",
                     "hyperposterior"):
            mod = importlib.import_module(f"fastgaussianprocesses_torch.examples.{name}")
            t0 = time.perf_counter()
            if mod.main() is not True:
                raise AssertionError(f"example {name} failed")
            torch.cuda.synchronize()
            out[name] = time.perf_counter() - t0
            log(f"  example {name}: {out[name]:.2f} s")
    return out


def host_points():
    """Host point generation at the main path's size (d = 8, n = 2^20): the
    lattice from the g++ library and from its numpy path (bit for bit equal),
    the digital net's numpy doubling (it has no library path); best of 3."""
    from fastgaussianprocesses_torch.points import native
    from fastgaussianprocesses_torch.points.digital_net import DigitalNetB2
    from fastgaussianprocesses_torch.points.lattice import LatticeSeq

    def best_ms(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return min(ts), out

    if native.load() is None:
        raise AssertionError("the host lattice library did not build")
    seq = LatticeSeq(D, seed=7)
    lib_ms, a = best_ms(lambda: seq(0, N_MAIN))
    np_ms, b = best_ms(lambda: seq.numpy_points(0, N_MAIN))
    if not np.array_equal(a, b):
        raise AssertionError("the host lattice library and numpy disagree")
    dn_ms, _ = best_ms(lambda: DigitalNetB2(D, seed=7)(0, N_MAIN))
    out = {"lattice_library_ms": lib_ms, "lattice_numpy_ms": np_ms,
           "digital_net_numpy_ms": dn_ms}
    log(f"  host points d={D} n=2^20: lattice library {lib_ms:.1f} ms, numpy {np_ms:.1f} ms "
        f"(equal); digital net numpy doubling {dn_ms:.1f} ms")
    return out


def phase7(torch, ft, tp, tf):
    """Phase 7 (see the module docstring); returns the cells' results."""
    res = {}
    log("  hmc_lattice: bench.py:bench_hmc, FastGPLattice(d=4) n=2^14 float32, fit(iterations=30), "
        "8 chains, 300 warmup, 50 samples")
    gp = fit_model(torch, ft.FastGPLattice, N_HMC, d=D_HMC, dtype=torch.float32)
    with refuse_plain(tp, tf):
        gp.fit(iterations=30, verbose=0)
    if type(gp._solver()).__name__ != "_PermSpectrumSolver":
        raise AssertionError("hmc_lattice did not take the permuted path")
    res["hmc_lattice"] = phase_hmc(torch, tp, tf, "hmc_lattice", gp, "lattice",
                                   dict(num_samples=50, num_warmup=300, num_chains=C_HMC, seed=0))
    log("  hmc_flagship: FastGPLattice(d=8) n=2^20 float32, 8 chains, 20 warmup, 20 samples, "
        "max_leapfrog 32")
    gp = fit_model(torch, ft.FastGPLattice, N_MAIN, d=D, dtype=torch.float32)
    res["hmc_flagship"] = phase_hmc(torch, tp, tf, "hmc_flagship", gp, "lattice",
                                    dict(num_samples=20, num_warmup=20, num_chains=C_HMC, seed=0,
                                         max_leapfrog=32))
    del gp
    torch.cuda.empty_cache()
    log("  hmc_dnb2: FastGPDigitalNetB2(d=4) n=2^14 float32, 8 chains, 50 warmup, 50 samples")
    gp = fit_model(torch, ft.FastGPDigitalNetB2, N_HMC, d=D_HMC, dtype=torch.float32)
    res["hmc_dnb2"] = phase_hmc(torch, tp, tf, "hmc_dnb2", gp, "dnb2",
                                dict(num_samples=50, num_warmup=50, num_chains=C_HMC, seed=0))
    log("  standard")
    res["standard"] = phase_standard(torch, ft)
    log("  examples")
    res["examples"] = phase_examples(torch, tp, tf)
    res["host_points"] = host_points()
    log("  cross-checks")
    hmc_crosscheck(torch, ft, tp, tf)
    standard_crosscheck(torch, ft)
    return res


# ---- phase 8 and --multichip: the parallel layer ----------------------------------------

PARALLEL_ONE = dict(full=False, n_fleet=N_FLEET, n_seq=N_MAIN, n_hmc=N_HMC,
                    hmc_lattice=dict(num_samples=20, num_warmup=20, num_chains=C_HMC, seed=0))
PARALLEL_FULL = dict(full=True, n_fleet=N_FLEET, n_seq=N_MAIN, n_seq64=N_FLEET,
                     n_mem=(N_MAIN, 1 << 22), n_hmc=N_HMC, n_flag=N_MAIN, n_query=N_QUERY,
                     mt_ns=MT_NS, n_query_mt=1024,
                     hmc_lattice=dict(num_samples=50, num_warmup=300, num_chains=C_HMC, seed=0),
                     hmc_flagship=dict(num_samples=20, num_warmup=20, num_chains=C_HMC, seed=0,
                                       max_leapfrog=32))


def phase_parallel(torch):
    """Phase 8: ``parallel/smoke.body`` in a process group of one (NCCL over a
    ``FileStore`` in a temporary directory), destroyed after."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from fastgaussianprocesses_torch.parallel import smoke
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
                                device_id=torch.device("cuda", 0))
        try:
            return smoke.body(0, 1, dict(PARALLEL_ONE, dtype=torch.float32))
        finally:
            dist.destroy_process_group()


def multichip(torch):
    """``--multichip``: build here, then ``parallel/smoke.body`` on one NCCL
    rank a card, then the ranks' kernel shapes on card 0."""
    from fastgaussianprocesses_torch.ops import cuda_lib, fwht as tf, perm_fft as tp
    from fastgaussianprocesses_torch.ops import transforms as ttr
    from fastgaussianprocesses_torch.parallel import dryrun, smoke
    from fastgaussianprocesses_torch.points import native

    cards = torch.cuda.device_count()
    smi = smi_line()
    log(f"card: {smi}; {cards} cards; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cards < 2:
        raise AssertionError(f"--multichip needs several cards, found {cards}")
    t0 = time.perf_counter()
    cuda_lib.build()
    if native.load() is None:
        raise AssertionError("the host lattice library (g++) did not build")
    log(f"  builds (nvcc, g++) in the parent: {time.perf_counter() - t0:.1f} s")
    log(f"phase 8 on {cards} cards: one NCCL rank a card")
    t0 = time.perf_counter()
    res = dryrun.run_ranks(smoke.body, cards, dict(PARALLEL_FULL, dtype=torch.float32),
                           backend="nccl", timeout=1000.0, collective_timeout=300.0)
    log(f"  ranks: {time.perf_counter() - t0:.1f} s")
    out = res[0]
    print(json.dumps({"parallel": out}, default=str))
    per = C_HMC // cards
    fleet_rows = B_FLEET // cards
    # K4's roles on the sequence-mesh paths: (name, [n, rows, launches] on rank 0)
    seq_roles = [
        ("K4 fwht.fwht (sequence-sharded serving, digital net, a rank's blocks)",
         out["seq_serving"]["dnb2"]["k4_shapes"]),
        ("K4 fwht.fwht (sequence-sharded mt_dnb2 MLL and gradient, a rank's pair blocks)",
         out["seq_multitask"]["step_k4_shapes"]),
        ("K4 fwht.fwht (sequence-sharded mt_dnb2 serving, a rank's blocks)",
         out["seq_multitask"]["serve_k4_shapes"]),
        ("K4 fwht.fwht (sequence-sharded hmc_flagship digital net, 8 chains' rank blocks)",
         out["seq_hmc"]["dnb2"]["k4_shapes"]),
        ("K4 fwht.fwht (hmc_flagship digital net on the 2 x 2 mesh of chains and sequence, "
         "a rank's 4 chains' blocks)", out["seq_hmc"]["dnb2"]["two_d"]["k4_shapes"]),
        ("K4 fwht.fwht (sharded fleet step, digital net, on the 2 x 2 mesh of batch and "
         "sequence, a rank's members' blocks)", out["fleet_2d"]["dnb2"]["k4_shapes"])]
    seq_shapes = sorted({(n, R) for _, shapes in seq_roles for n, R, _ in shapes})
    log("K1-K4 at a rank's shapes, on card 0, as phase 3 holds and times them")
    rows = phase_kernels(torch, tp, tf,
                         extra=[(N_FLEET, fleet_rows), (N_HMC, per), (N_MAIN, per)], base=False)
    rows.update({("K4",) + k: v for k, v in phase_fwht(
        torch, tf, ttr, NB_DIGITAL, extra=sorted({(N_FLEET, fleet_rows), (N_MAIN // cards, 1),
                                                  *seq_shapes}),
        base=False).items()})
    src, fwsrc = ("fastgaussianprocesses_torch/csrc/perm_fft.cu",
                  "fastgaussianprocesses_torch/csrc/fwht.cu")
    rep = {"K1": "pallas_fft.py:129", "K2": "pallas_fft.py:268", "K4": "pallas_fwht.py:59"}
    fl, fd = out["fleet"]["lattice"]["launches_a_step"], out["fleet"]["dnb2"]["launches_a_step"]
    sd = out["seq"]["dnb2"]["MLL"]["launches"]
    hl = out["hmc"]["hmc_lattice"]["launches"]
    hf = out["hmc"]["hmc_flagship"]["launches"]
    roles = [("K1 perm_fft.pfft (sharded fleet step, lattice, a rank's members)",
              ("K1", N_FLEET, fleet_rows), fl["pfft"]),
             ("K2 as pfft's backward (sharded fleet step, lattice)",
              ("K2", N_FLEET, fleet_rows), fl["pifft_real"]),
             ("K4 fwht.fwht (sharded fleet step, digital net, eigenvalues and backward)",
              ("K4", N_FLEET, fleet_rows), fd["fwht"]),
             ("K4 fwht.fwht (sequence-sharded digital net, a rank's block; MLL and gradient)",
              ("K4", N_MAIN // cards, 1), sd["fwht"]),
             ("K1 perm_fft.pfft (chain-sharded hmc_lattice, a rank's chains; the timed run)",
              ("K1", N_HMC, per), hl["pfft"]),
             ("K2 as pfft's backward (chain-sharded hmc_lattice; the timed run)",
              ("K2", N_HMC, per), hl["pifft_real"]),
             ("K1 perm_fft.pfft (chain-sharded hmc_flagship, a rank's chains; the timed run)",
              ("K1", N_MAIN, per), hf["pfft"]),
             ("K2 as pfft's backward (chain-sharded hmc_flagship; the timed run)",
              ("K2", N_MAIN, per), hf["pifft_real"])]
    roles += [(f"{name}, n=2^{int(math.log2(n))} R={R}", ("K4", n, R), c)
              for name, shapes in seq_roles for n, R, c in shapes]
    kernels = []
    for name, key, launches in roles:
        r = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": fwsrc if key[0] == "K4" else src,
                        "replaces": "fastgaussianprocesses_tpu/ops/" + rep[key[0]],
                        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "shape": f"n=2^{int(math.log2(key[1]))}, R={key[2]}"})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": cards}}))
    return 0


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if argv[:1] == ["--fwht-times"]:
        # K4's times alone, for the package at argv[1] (default: this checkout's)
        if len(argv) > 1:
            sys.path.insert(0, os.path.abspath(argv[1]))
        from fastgaussianprocesses_torch.ops import fwht as tf, transforms as ttr
        log(f"card: {smi_line()}; package {os.path.dirname(tf.__file__)}")
        times = fwht_times(torch, tf, ttr, NB_DIGITAL, torch.Generator().manual_seed(1))
        print(json.dumps({"fwht_times": times}))
        return 0
    if argv[:1] == ["--multichip"]:
        return multichip(torch)
    import fastgaussianprocesses_torch as ft
    from fastgaussianprocesses_torch.kernels import series
    from fastgaussianprocesses_torch.ops import cuda_lib, fwht as tf, perm_fft as tp
    from fastgaussianprocesses_torch.ops import si_cross as sc, transforms as ttr
    if argv[:1] == ["--si-cross-times"]:
        log(f"card: {smi_line()}")
        print(json.dumps({"si_cross_times": si_cross_times(torch, sc, series)}))
        return 0

    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("phase 1: build")
    t0 = time.perf_counter()
    cuda_lib.build()
    log(f"  nvcc build of {', '.join(s.name for s in cuda_lib.SOURCES)}: "
        f"{time.perf_counter() - t0:.1f} s")
    from fastgaussianprocesses_torch.points import native
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the host lattice library (g++) did not build")
    log(f"  g++ build of {native.SOURCE.name}: {time.perf_counter() - t0:.1f} s")
    t2 = time.perf_counter()
    log("phase 2: serving FastGPLattice(d=8) at n=2^20 on the card")
    counts, nb_lattice = phase_serving(torch, ft, (tp, tf, sc), ft.FastGPLattice,
                                       "_PermSpectrumSolver",
                                       ("pfft", "pifft_real", "quad", "si_cross", "si_pair"),
                                       ("pass_a_kernel", "slab_kernel", "si_"),
                                       per_chunk=("si_cross", "si_pair"))
    if nb_lattice != NB_LATTICE:
        raise AssertionError(f"the lattice's query chunk is {nb_lattice} rows, not {NB_LATTICE}")
    log("phase 2: serving FastGPDigitalNetB2(d=8) at n=2^20 on the card")
    counts_dn, nb = phase_serving(torch, ft, (tp, tf), ft.FastGPDigitalNetB2, "_FastSolver",
                                  ("fwht",), ("fwht_",), no_centred_copy=True)
    if nb != NB_DIGITAL:
        raise AssertionError(f"the digital net's query chunk is {nb} rows, not {NB_DIGITAL}")
    log(f"  phase 2: {time.perf_counter() - t2:.1f} s")
    t3 = time.perf_counter()
    log("phase 3: kernels against their plain versions")
    # and at phase 6's shapes: fleet_lattice's eigenvalues (K1, K2 its backward) and
    # query chunk (K3 a member); mt_dnb2's shorter tasks' eigenvalues and query rows (K4)
    # and phase 7's: every HMC chain a row of K1/K2 (n = 2^14 and 2^20) or K4 (2^14)
    rows = phase_kernels(torch, tp, tf, extra=[(N_FLEET, B_FLEET), (N_FLEET, NB_FLEET),
                                           (N_HMC, C_HMC), (N_MAIN, C_HMC)])
    rows_fwht = phase_fwht(torch, tf, ttr, nb, extra=[(N_MAIN // 2, 1), (N_MAIN, 3 * NB_MT),
                                                      (N_HMC, C_HMC), (N_FLEET, B_FLEET)])
    row_pifft, counts_pifft = phase_pifft(torch, tp, tf, ttr)
    row_k5 = si_cross_times(torch, sc, series)
    log(f"  phase 3: {time.perf_counter() - t3:.1f} s")
    t4 = time.perf_counter()
    log("phase 4: cross-check at n=2^16, d=8")
    # card f32 against CPU f32 runs the same arithmetic but for the kernels'
    # summation order (measured on the H100: lattice at most 6.4e-6; digital
    # net pm 6.5e-6, pv 1.9e-6, coeffs 2.4e-5, cubature 0); f32 against f64
    # at this conditioning (measured on the CPU: lattice pm 2.7e-5, pv
    # 6.4e-5, coeffs 4.2e-4, cubature mean 6.5e-6, cubature var 2.6e-4;
    # digital net pm 1.1e-4, pv 1.4e-3, coeffs 3.3e-3, cubature mean 1.3e-6,
    # cubature var 6.9e-3)
    phase_crosscheck(torch, ft, ft.FastGPLattice,
                     ("card f32 perm", "cpu f32 perm (plain kernels)", "cpu f64 half spectrum"),
                     ((5e-5,) * 5, (2e-4, 5e-4, 4e-3, 5e-5, 2e-3)))
    phase_crosscheck(torch, ft, ft.FastGPDigitalNetB2,
                     ("card f32 fwht", "cpu f32 (plain fwht)", "cpu f64"),
                     ((5e-5, 5e-5, 1e-4, 5e-5, 5e-5), (5e-4, 5e-3, 1.5e-2, 5e-6, 3e-2)))

    log(f"  phase 4: {time.perf_counter() - t4:.1f} s")
    t5 = time.perf_counter()
    log("phase 5: fit at n=2^20, d=8 on the card (the plain kernel versions refused)")
    log("  FastGPLattice (MLL: K1 forward, K2 its backward; CV: K2 forward, K1 its backward)")
    fit_counts, fit_res = phase_fit(torch, ft, tp, tf, ft.FastGPLattice, "_PermSpectrumSolver",
                                    {"pfft": 1, "pifft_real": 1}, ("pass_a_kernel", "slab_kernel"),
                                    cv_per_step={"pfft": 2, "pifft_real": 2})
    log("  FastGPDigitalNetB2 (MLL: K4 forward and backward)")
    fit_counts_dn, fit_res_dn = phase_fit(torch, ft, tp, tf, ft.FastGPDigitalNetB2, "_FastSolver",
                                          {"fwht": 2}, ("fwht_",))
    log("  gradient at n=2^16, d=8, noise 1.0")
    fit_grad_check(torch, ft, tp, tf, ft.FastGPLattice,
                   ("card f32 perm", "cpu f32 perm (plain kernels)", "cpu f64 half spectrum"))
    fit_grad_check(torch, ft, tp, tf, ft.FastGPDigitalNetB2,
                   ("card f32 fwht", "cpu f32 (plain fwht)", "cpu f64"))
    log("  each backward alone")
    bwd = backward_checks(torch, tp, tf)
    log(f"  phase 5: {time.perf_counter() - t5:.1f} s")
    print(json.dumps({"fit_step": {"FastGPLattice": fit_res, "FastGPDigitalNetB2": fit_res_dn}}))

    log("phase 6: multitask, derivative-informed and fleet models on the card (the plain "
        "kernel versions refused)")
    t6 = time.perf_counter()
    mt = phase_multitask(torch, ft, tp, tf)
    log(f"  phase 6: {time.perf_counter() - t6:.1f} s")
    print(json.dumps({"multitask": mt}))

    log("phase 7: the HMC hyperposterior, StandardGP and the examples on the card (the plain "
        "kernel versions refused)")
    t7 = time.perf_counter()
    p7 = phase7(torch, ft, tp, tf)
    log(f"  phase 7: {time.perf_counter() - t7:.1f} s")
    print(json.dumps({"hmc_standard_examples": p7}))

    log("phase 8: the parallel layer in a process group of one (NCCL; the plain kernel "
        "versions refused)")
    t8 = time.perf_counter()
    p8 = phase_parallel(torch)
    log(f"  phase 8: {time.perf_counter() - t8:.1f} s")
    print(json.dumps({"parallel_one_card": p8}, default=str))

    src = "fastgaussianprocesses_torch/csrc/perm_fft.cu"
    spec = [("K1 perm_fft.pfft", "K1", 1, "pfft", "fastgaussianprocesses_tpu/ops/pallas_fft.py:129"),
            ("K2 perm_fft.pifft_real", "K2", 1, "pifft_real",
             "fastgaussianprocesses_tpu/ops/pallas_fft.py:268"),
            ("K3 perm_fft.quad_partials", "K3", 59, "quad",
             "fastgaussianprocesses_tpu/ops/pallas_fft.py:419")]
    kernels = []
    for name, k, R, counter, replaces in spec:
        r = rows[(k, N_MAIN, R)]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[counter], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "op_ms": r["op_ms"], "shape": f"n=2^20, R={R}"})
    kernels.append({"name": "K2 perm_fft.pifft (complex output)", "route": "cuda", "source": src,
                    "replaces": "fastgaussianprocesses_tpu/ops/pallas_fft.py:268",
                    "launches": counts_pifft["pifft"], "shape": "n=2^20, R=1",
                    **{k: row_pifft[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "op_ms")}})
    kernels.append({"name": "K5 si_cross.si_cross", "route": "cuda",
                    "source": "fastgaussianprocesses_torch/csrc/si_cross.cu",
                    "replaces": "none (kernels/series.kernel_fused_scan's loop; XLA fuses the "
                                "JAX package's lax.scan)",
                    "launches": counts["si_cross"], "library_ms": None,
                    "shape": f"n=2^20, R={NB_LATTICE}, d={D}",
                    **{k: row_k5[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "op_ms", "loop_ms")}})
    r = rows_fwht[(N_MAIN, nb)]
    kernels.append({"name": "K4 fwht.fwht", "route": "cuda",
                    "source": "fastgaussianprocesses_torch/csrc/fwht.cu",
                    "replaces": "fastgaussianprocesses_tpu/ops/pallas_fwht.py:59",
                    "launches": counts_dn["fwht"], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None, "op_ms": r["op_ms"],
                    "shape": f"n=2^20, R={nb}"})
    for name, replaces, launches in (
            ("K2 as pfft's backward", "pallas_fft.py:268", fit_counts["pifft_real"]),
            ("K1 as pifft_real's backward", "pallas_fft.py:129", fit_counts["cv"]["pfft"]),
            ("K4 as fwht's backward", "pallas_fwht.py:59", fit_counts_dn["fwht"])):
        r = bwd[name]
        kernels.append({"name": name + " (fit)", "route": "cuda",
                        "source": src if name[1] in "12" else
                        "fastgaussianprocesses_torch/csrc/fwht.cu",
                        "replaces": "fastgaussianprocesses_tpu/ops/" + replaces,
                        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": "n=2^20, R=1"})
    fwsrc = "fastgaussianprocesses_torch/csrc/fwht.cu"
    for name, src_, replaces, r, shape, launches in (
            ("K4 fwht.fwht (mt_dnb2 fit, eigenvalues and backward)", fwsrc, "pallas_fwht.py:59",
             rows_fwht[(N_MAIN // 2, 1)], "n=2^19, R=1",
             mt["mt_dnb2"]["fits"][0]["launches"]["fwht"]),
            ("K4 fwht.fwht (mt_dnb2 serving, query rows)", fwsrc, "pallas_fwht.py:59",
             rows_fwht[(N_MAIN, 3 * NB_MT)], f"n=2^20, R={3 * NB_MT}",
             mt["mt_dnb2"]["serve_launches"]["fwht"]),
            ("K1 perm_fft.pfft (fleet_lattice fit, eigenvalues)", src, "pallas_fft.py:129",
             rows[("K1", N_FLEET, B_FLEET)], f"n=2^16, R={B_FLEET}",
             mt["fleet_lattice"]["fits"][0]["launches"]["pfft"]),
            ("K2 as pfft's backward (fleet_lattice fit)", src, "pallas_fft.py:268",
             rows[("K2", N_FLEET, B_FLEET)], f"n=2^16, R={B_FLEET}",
             mt["fleet_lattice"]["fits"][0]["launches"]["pifft_real"]),
            ("K3 perm_fft.quad_partials (fleet_lattice serving, a member)", src,
             "pallas_fft.py:419", rows[("K3", N_FLEET, NB_FLEET)], f"n=2^16, R={NB_FLEET}",
             mt["fleet_lattice"]["serve_launches"]["quad"]),
            ("K1 perm_fft.pfft (hmc_lattice, 8 chains' eigenvalues)", src, "pallas_fft.py:129",
             rows[("K1", N_HMC, C_HMC)], f"n=2^14, R={C_HMC}",
             p7["hmc_lattice"]["launches"]["pfft"]),
            ("K2 as pfft's backward (hmc_lattice, 8 chains)", src, "pallas_fft.py:268",
             rows[("K2", N_HMC, C_HMC)], f"n=2^14, R={C_HMC}",
             p7["hmc_lattice"]["launches"]["pifft_real"]),
            ("K1 perm_fft.pfft (hmc_flagship, 8 chains' eigenvalues)", src, "pallas_fft.py:129",
             rows[("K1", N_MAIN, C_HMC)], f"n=2^20, R={C_HMC}",
             p7["hmc_flagship"]["launches"]["pfft"]),
            ("K2 as pfft's backward (hmc_flagship, 8 chains)", src, "pallas_fft.py:268",
             rows[("K2", N_MAIN, C_HMC)], f"n=2^20, R={C_HMC}",
             p7["hmc_flagship"]["launches"]["pifft_real"]),
            ("K4 fwht.fwht (hmc_dnb2, 8 chains' eigenvalues and backward)", fwsrc,
             "pallas_fwht.py:59", rows_fwht[(N_HMC, C_HMC)], f"n=2^14, R={C_HMC}",
             p7["hmc_dnb2"]["launches"]["fwht"]),
            ("K1 perm_fft.pfft (phase 8: sharded fleet step, lattice, one rank)", src,
             "pallas_fft.py:129", rows[("K1", N_FLEET, B_FLEET)], f"n=2^16, R={B_FLEET}",
             p8["fleet"]["lattice"]["launches_a_step"]["pfft"]),
            ("K2 as pfft's backward (phase 8: sharded fleet step, lattice)", src,
             "pallas_fft.py:268", rows[("K2", N_FLEET, B_FLEET)], f"n=2^16, R={B_FLEET}",
             p8["fleet"]["lattice"]["launches_a_step"]["pifft_real"]),
            ("K4 fwht.fwht (phase 8: sharded fleet step, digital net)", fwsrc,
             "pallas_fwht.py:59", rows_fwht[(N_FLEET, B_FLEET)], f"n=2^16, R={B_FLEET}",
             p8["fleet"]["dnb2"]["launches_a_step"]["fwht"]),
            ("K4 fwht.fwht (phase 8: sequence-sharded digital net, one rank's block)", fwsrc,
             "pallas_fwht.py:59", rows_fwht[(N_MAIN, 1)], "n=2^20, R=1",
             p8["seq"]["dnb2"]["MLL"]["launches"]["fwht"]),
            ("K1 perm_fft.pfft (phase 8: chain-sharded hmc_lattice, 20 + 20 iterations)", src,
             "pallas_fft.py:129", rows[("K1", N_HMC, C_HMC)], f"n=2^14, R={C_HMC}",
             p8["hmc"]["hmc_lattice"]["launches"]["pfft"]),
            ("K2 as pfft's backward (phase 8: chain-sharded hmc_lattice, 20 + 20 iterations)",
             src, "pallas_fft.py:268", rows[("K2", N_HMC, C_HMC)], f"n=2^14, R={C_HMC}",
             p8["hmc"]["hmc_lattice"]["launches"]["pifft_real"])):
        kernels.append({"name": name, "route": "cuda", "source": src_,
                        "replaces": "fastgaussianprocesses_tpu/ops/" + replaces,
                        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms"),
                        "shape": shape})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
