"""Process-group bring-up and scaling measurements (counterpart of
``fastgaussianprocesses_tpu/parallel/distributed.py``).

One process a card: ``torch.distributed`` with NCCL where the process has a
card and gloo otherwise, started by ``torch.multiprocessing`` or
``torchrun`` (``env://``), or from explicit arguments (``tcp://``).  The
argument-free :func:`initialize` in a process with no ``WORLD_SIZE`` is the
single-process topology, as in the JAX package: a logged no-op.
"""

import datetime
import logging
import math
import os
import time

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               initialization_timeout=None):
    """Join the process group.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` starts it over ``tcp://``; without it, ``env://`` reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (as
    ``torchrun`` sets them).  ``initialization_timeout`` in seconds (default
    300).  When a topology is asked for explicitly (any argument given), a
    failure raises ``RuntimeError``: a misconfigured launch must not become
    a silent single-process run.  The argument-free call in a process with
    no ``WORLD_SIZE`` logs a single-process run and returns.  On NCCL each
    process takes the card ``LOCAL_RANK`` (or its rank modulo the cards)."""
    explicit = not (coordinator_address is None and num_processes is None
                    and process_id is None)
    if dist.is_initialized():
        return
    if not explicit and "WORLD_SIZE" not in os.environ:
        logger.info("single-process run (no WORLD_SIZE in the environment)")
        return
    backend = _backend()
    timeout = datetime.timedelta(seconds=300 if initialization_timeout is None
                                 else float(initialization_timeout))
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    try:
        if backend == "nccl":
            local = os.environ.get("LOCAL_RANK")
            rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
            torch.cuda.set_device(int(local) if local is not None
                                  else rank % torch.cuda.device_count())
        init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init, timeout=timeout, **kw)
    except Exception as e:
        if explicit:
            raise RuntimeError(
                f"multi-host initialize failed for explicit topology "
                f"(coordinator={coordinator_address}, num_processes={num_processes}, "
                f"process_id={process_id})") from e
        logger.info("single-process run (env:// initialization failed: %s)", e)
        return
    logger.info("distributed initialized: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)


def global_mesh(axis_sizes: dict):
    """Mesh over every rank of the default group ({axis: size}, -1 = the
    remaining ranks)."""
    from .mesh import make_mesh
    return make_mesh(axis_sizes)


def process_local_batch(global_batch: int) -> slice:
    """The slice of a leading global batch axis that this process owns (the
    whole axis in a single-process run)."""
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % nproc:
        raise ValueError(f"a batch of {global_batch} does not split over {nproc} processes")
    per = global_batch // nproc
    return slice(i * per, (i + 1) * per)


def hmc_scaling_efficiency(samples_per_sec: dict) -> float:
    """Scaling efficiency from {num_devices: samples/s}: samples/s a device
    at the most devices over samples/s a device at the fewest."""
    ks = sorted(samples_per_sec)
    base = samples_per_sec[ks[0]] / ks[0]
    top = samples_per_sec[ks[-1]] / ks[-1]
    return float(top / base)


def _first_ranks(k: int):
    """A group of ranks 0..k-1 (every rank must call this)."""
    return dist.new_group(list(range(k)))


def _share(value):
    """Rank 0's picklable ``value`` on every rank."""
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def measure_collective_overhead(num_chains=8, device_counts=None, steps=500, size=8):
    """The HMC step's cross-chain traffic in isolation: each of the first k
    ranks holds ``num_chains / k`` rows of ``size`` values, and each of
    ``steps`` steps adds ``1e-6`` times their global mean, one scalar
    ``all_reduce`` over a subgroup of the k ranks a step.  Every rank of the
    default group must call it.

    Returns ``{"steps_per_s": {k}, "latency_s": {k}}`` (best of 3 timed runs
    after a warm one; the host waits on the result of each run), the same
    on every rank.  With trivial compute the number is what one all-reduce
    adds to an HMC step."""
    world = dist.get_world_size()
    device_counts = (1, world) if device_counts is None else tuple(device_counts)
    device = torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")
    results = {}
    for k in device_counts:
        if num_chains % k or k > world:
            raise ValueError(f"{num_chains} chains over {k} of {world} ranks")
        group = _first_ranks(k)
        if dist.get_rank() < k:
            x = torch.ones((num_chains // k, size), dtype=torch.float32, device=device)
            total = float(num_chains * size)

            def run(c):
                for _ in range(steps):
                    m = c.sum()
                    dist.all_reduce(m, group=group)
                    c = c + 1e-6 * (m / total)
                return float(c.sum())  # the host waits for the run

            run(x)
            best = math.inf
            for _ in range(3):
                t0 = time.perf_counter()
                run(x)
                best = min(best, time.perf_counter() - t0)
            results[k] = steps / best
        dist.barrier()
    results = _share(results)
    ks = sorted(results)
    return {"steps_per_s": {str(k): results[k] for k in ks},
            "latency_s": {str(k): 1.0 / results[k] for k in ks}}


def measure_hmc_scaling(model, num_chains=8, device_counts=None, num_samples=100,
                        num_warmup=100, seed=0, **hmc_kw):
    """Chain-sharded HMC throughput over device counts: a FIXED total of
    ``num_chains`` chains over the first k ranks, for each k (k = 1: the
    unsharded sampler on rank 0), a warm run of the same configuration
    first, then one timed run (the host fetches its log-densities).  Every
    rank of the default group must call it, each with the same model.

    Returns ``{"samples_per_s": {k: float}, "efficiency": float}``, the same
    on every rank: ``efficiency`` is samples/s at the most ranks over
    samples/s at the fewest, k at most.  The chains are independent, so a
    sharded run does the same total work in C / k rows a rank: it gains
    where a gradient's device time shrinks with its rows, and stays flat
    where the host's launches set the pace."""
    from ..fit.hmc import sample_gp_hyperposterior
    from .mesh import batch_sharding, make_mesh

    world = dist.get_world_size()
    device_counts = (1, world) if device_counts is None else tuple(device_counts)
    results = {}
    for k in device_counts:
        if num_chains % k or k > world:
            raise ValueError(f"{num_chains} chains over {k} of {world} ranks")
        mesh = make_mesh({"chains": k}, devices=list(range(k))) if k > 1 else None
        if dist.get_rank() < k:
            sharding = batch_sharding(mesh, "chains") if k > 1 else None
            kw = dict(num_samples=num_samples, num_warmup=num_warmup,
                      num_chains=num_chains, seed=seed, chain_sharding=sharding, **hmc_kw)
            res, _ = sample_gp_hyperposterior(model, **kw)
            res.log_prob.cpu()
            t0 = time.perf_counter()
            res, _ = sample_gp_hyperposterior(model, **kw)
            res.log_prob.cpu()
            results[k] = num_samples * num_chains / (time.perf_counter() - t0)
        dist.barrier()
    results = _share(results)
    ks = sorted(results)
    return {"samples_per_s": results,
            "efficiency": float(results[ks[-1]] / results[ks[0]])}
