"""Readings that a cell's limits of correctness are set from, on the card.

    python3 gpbench/calibrate.py --workload <name> --seeds <first> <count>
        [--seconds s] [--fault <name of gpbench/faults.py>] [--witness]

For each seed, in one process: a run of the cell (set-up, a short window at
the cell's own load, the check against the float64 reference), then the
control, the reference computed in bfloat16 in the program's place on the
same inputs.  One JSON line a seed: the program's numbers (the lower
readings) and the control's (the upper).  With ``--fault`` the fault is
planted underneath the program first, and its numbers are the fault's
readings.  With ``--witness`` the line adds the numbers of the reference
computed natively in float32 in the program's place: what the
configurations' precision itself reads.  The benchmark's runs do not run
this.
"""

import argparse
import gc
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True, metavar=("FIRST", "COUNT"))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, CHECKOUT)
    import torch

    from gpbench import faults
    from gpbench.harness import cell, registry

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = registry.config(wl["config"])
    if args.fault:
        faults.BY_NAME[args.fault](setattr)
    for seed in range(args.seeds[0], args.seeds[0] + args.seeds[1]):
        t0 = time.perf_counter()
        result, run = cell.run_cell(bench, args.workload, seed, args.seconds, 0, "cuda", t0)
        drv = registry.driver(run.traffic["kind"])
        line = {"seed": seed, "fault": args.fault, "correct": result["correct"],
                "program": {k: c["value"] for k, c in result["compared"].items()},
                "control": drv.check(run, registry.reference(cfg), control="bfloat16")}
        if args.witness:
            line["witness"] = drv.check(run, registry.reference(cfg), control="float32")
        line.update(metrics=result["metrics"], work=run.work,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
