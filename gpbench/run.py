"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is the JSON
result; the last lines of standard error name each number compared with
its limit.  The CUDA kernels build at first use into the checkout
(``fastgaussianprocesses_torch/_build``), and every other cache goes to
``_gpbench_cache/`` there.  The process runs its host work on one thread.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    # one process with few threads: the host's other work is the noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(CHECKOUT, "_gpbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    from gpbench.harness import cell

    return cell.main(argv, t0=T0, checkout=CHECKOUT)


if __name__ == "__main__":
    sys.exit(main())
