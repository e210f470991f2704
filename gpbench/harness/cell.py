"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

``python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs a cell of ``BENCHMARK.json`` on the card.  The cell's configuration,
traffic mix, limits and per-layer metric readers are found by name
(``registry``); the mix's ``kind`` picks the driver (``harness/<kind>.py``),
which sets up the program, runs the window, frees the program's state and
computes the numbers compared.  A driver declares the mix's key that caps
the traced window's units (``TRACE_UNITS``) and the chip counts it drives
(``CHIPS``).
"""

import argparse
import contextlib
import gc
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import guard, registry
from .trace import Tracer, span


class Run:
    """What a driver reads (configuration, mix, seed, device) and fills
    (its program state, outputs, counts and set-up readings)."""

    def __init__(self, cfg, traffic, seed, device, tracer=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.tracer = tracer
        self.setup = {}
        self.work = {}
        self.trace = None
        self.errors = []
        self.attempted = self.failed = 0

    def span(self, name):
        """A benchmark span around a unit of work, in the traced run only."""
        return contextlib.nullcontext() if self.tracer is None else span(name)


class Context:
    """What a per-layer metric reader takes: the run, the reduced trace, the
    recorded kernel-op calls, the window's seconds and the configuration's
    FLOP counts (``registry.flops``)."""

    def __init__(self, run, trace, records, elapsed, flops):
        self.run, self.trace, self.records, self.elapsed = run, trace, records, elapsed
        self.cfg, self.traffic, self.work, self.flops = run.cfg, run.traffic, run.work, flops


def _selected(metrics, workload):
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def run_cell(bench, workload, seed, seconds, trace, device, t0, root=registry.ROOT):
    """Run one cell; returns ``(result, run)``: the result line's dict (its
    ``compared`` last) and the run, which keeps the outputs checked."""
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = registry.config(wl["config"], root)
    traffic = registry.traffic(wl["traffic"], root)
    limits = registry.limits(workload, root)
    readers = {}
    tracer = None
    if trace:
        readers = {m["name"]: registry.metric(m["name"], root)
                   for m in _selected(bench["per_layer"], workload)}
        tracer = Tracer(spans=[s for r in readers.values() for s in getattr(r, "SPANS", ())],
                        calls=[c for r in readers.values() for c in getattr(r, "CALLS", ())])
    drv = registry.driver(traffic["kind"])
    run = Run(cfg, traffic, seed, device, tracer)
    drv.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    max_units = int(traffic[drv.TRACE_UNITS]) if trace else None
    if tracer:
        tracer.install()
        tracer.start(run.device)
    try:
        elapsed = drv.window(run, seconds, max_units)
    finally:
        if tracer:
            tracer.stop(run.device)
            tracer.uninstall()
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    summary = run.trace = tracer.summary() if tracer else None
    drv.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check(run, registry.reference(cfg))
    compared = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    correct = run.failed == 0 and all(math.isfinite(v) and v <= lim
                                      for v, lim in compared.values())
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        ctx = Context(run, summary, list(tracer.records), elapsed,
                      registry.flops(wl["config"], root))
        for name, reader in readers.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        for m in _selected(bench["end_to_end"], workload):
            value = setup_s if m["name"] == "setup_s" else drv.end_to_end(run, m["name"], elapsed)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name() if run.device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
    # a number that could not be computed, or is infinite, is null in the line
    result["compared"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result, run


def main(argv=None, t0=None, checkout=None):
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    checkout = Path(checkout or registry.ROOT.parent)
    with open(checkout / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"gpbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"gpbench: the cell needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    drv = registry.driver(registry.traffic(wl["traffic"])["kind"])
    if int(wl["chips"]) not in drv.CHIPS:
        print(f"gpbench: the {drv.__name__} driver runs on {drv.CHIPS} card(s), not "
              f"{wl['chips']}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, run = run_cell(bench, args.workload, args.seed, args.seconds, args.trace, "cuda", t0)
    bad = guard.forbidden_modules()
    if bad:
        print(f"gpbench: the process holds forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    for e in run.errors[:5]:
        print(f"gpbench: a unit failed: {e}", file=sys.stderr)
    if run.trace is not None:
        print(f"gpbench: traced {len(run.trace.kernels)} kernels, {run.trace.unmatched} not "
              f"linked to a host op", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0
