"""Profiling hooks (counterpart of ``fastgaussianprocesses_tpu/utils/profiling.py``):
a device trace of a block through ``torch.profiler``, and a step timer that
waits for the device before it reads the clock."""

import contextlib
import os
import time

import torch

from ..config import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Trace the enclosed block with ``torch.profiler`` (host and, on the
    card, CUDA activity) and write a Chrome trace to ``logdir/trace.json``.
    Yields the profiler, whose ``key_averages()`` sum the time by operator."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock timer for device work: on the card it synchronizes before
    reading the clock, so a time covers the work and not only its launch.

    >>> timer = StepTimer(device="cpu")
    >>> with timer:
    ...     _ = sum(range(10))
    >>> len(timer.times)
    1
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.times = []
        self._t0 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def record(self, out=None):
        """Time from ``__enter__`` until the device has finished (``out`` is
        accepted for the JAX package's signature; the sync covers it)."""
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self):
        return 1e3 * sum(self.times) / max(len(self.times), 1)
