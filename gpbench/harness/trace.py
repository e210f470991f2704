"""The traced run's instruments and the reduction of its profile.

In a ``--trace 1`` run the benchmark puts ``torch.profiler.record_function``
ranges (spans) around calls into the program's layers, records the shapes
of the calls of the public kernel ops, and profiles the window with
``torch.profiler``.  The profile stays in memory; :meth:`Tracer.summary`
reduces it to the numbers the per-layer readers take: the device's kernels
in the window, its busy time (the union of their intervals), the device
time of the kernels launched inside each span, the largest kernels, and the
idle gaps labelled with the benchmark span the host was in.  Span and
module names are given as strings; nothing here imports the program.
"""

import bisect
import functools
import importlib
import time
from collections import defaultdict

import torch

WINDOW = "gpbench.window"
NOT_KERNELS = ("Memcpy", "Memset")


def span(name):
    """A benchmark span: a profiler range named ``name``."""
    return torch.profiler.record_function(name)


class Tracer:
    """``spans``: (module, function, span name) triples, each function wrapped
    in a range of that name; ``calls``: (module, function, op name) triples,
    each call's tensor shapes recorded under the op name."""

    def __init__(self, spans=(), calls=()):
        self.spans = list(dict.fromkeys(tuple(s) for s in spans))
        self.calls = list(dict.fromkeys(tuple(c) for c in calls))
        self.records = []
        self._saved = []
        self.prof = None

    def install(self):
        for mod_name, attr, name in self.spans:
            self._wrap(mod_name, attr, self._ranged(name))
        for mod_name, attr, op in self.calls:
            self._wrap(mod_name, attr, self._recorded(op))

    def uninstall(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def _wrap(self, mod_name, attr, make):
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        self._saved.append((mod, attr, orig))
        setattr(mod, attr, make(orig))

    @staticmethod
    def _ranged(name):
        def make(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                with span(name):
                    return fn(*a, **k)
            return wrapper
        return make

    def _recorded(self, op):
        def make(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                ts = [t for t in a if torch.is_tensor(t)]
                ts += [t for t in k.values() if torch.is_tensor(t)]
                self.records.append((op, [tuple(t.shape) for t in ts],
                                     bool(ts and ts[0].is_complex())))
                return fn(*a, **k)
            return wrapper
        return make

    def start(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.records.clear()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._window = span(WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, device):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def summary(self):
        return Trace(self.prof.profiler.kineto_results.events(), self.wall_s)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(t, merged):
    """Whether time ``t`` lies in one of the sorted, disjoint ``merged``
    intervals."""
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


class Trace:
    """The reduced profile of one window (times in seconds), from the
    profiler's raw events.  A kernel belongs to a span when the host op or
    range that it is linked to (the innermost one open when it was
    launched) started inside the span's range."""

    def __init__(self, events, wall_s):
        cuda, host = [], []
        for e in events:
            (cuda if str(e.device_type()).endswith("CUDA") else host).append(e)
        win = [(e.start_ns(), e.end_ns()) for e in host if e.name() == WINDOW]
        w0, w1 = win[0] if win else (min((e.start_ns() for e in cuda), default=0),
                                     max((e.end_ns() for e in cuda), default=0))
        self.window_s = (w1 - w0) * 1e-9 if win else wall_s
        started = {}                      # host op or range id -> its start
        spans = defaultdict(list)
        for e in host:
            if e.linked_correlation_id() == 0:
                started[e.correlation_id()] = e.start_ns()
            if e.name().startswith("gpbench.") and e.name() != WINDOW:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
        self.kernels = []                 # (name, start ns, end ns, its host op's start or None)
        device = []
        for e in cuda:
            s, t = e.start_ns(), e.end_ns()
            name = e.name()
            if t < w0 or s > w1 or name.startswith("gpbench.") or e.is_user_annotation():
                continue
            device.append((max(s, w0), min(t, w1)))
            if not name.startswith(NOT_KERNELS):
                launch = started.get(e.linked_correlation_id())
                self.kernels.append((name, s, t, launch))
        self.unmatched = sum(k[3] is None for k in self.kernels)
        busy = _merge(device)
        self.busy_s = sum(t - s for s, t in busy) * 1e-9
        self.span_device_s = {}
        for name, ivs in spans.items():
            merged = _merge(ivs)
            self.span_device_s[name] = sum((t - s) * 1e-9 for _, s, t, launch in self.kernels
                                           if launch is not None and _inside(launch, merged))
        by_name = defaultdict(float)
        for name, s, t, _ in self.kernels:
            by_name[name] += (t - s) * 1e-9
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        labelled = sorted(((a, b, nm) for nm, ivs in spans.items() for a, b in ivs),
                          key=lambda ev: ev[1] - ev[0])      # innermost (shortest) first
        gaps, prev = defaultdict(float), w0
        for s, t in busy + [[w1, w1]]:
            if s > prev:
                label = next((nm for a, b, nm in labelled if a <= prev <= b), "outside spans")
                gaps[label] += (s - prev) * 1e-9
            prev = max(prev, t)
        self.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])

    def kernel_s(self, patterns):
        """Device seconds of the window's kernels whose names hold any of the
        ``patterns``."""
        return sum((t - s) * 1e-9 for name, s, t, _ in self.kernels
                   if any(p in name for p in patterns))

    def breakdown(self):
        return {"device_ops": [[k[:120], v] for k, v in self.device_ops[:10]],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:10]]}
