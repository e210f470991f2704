"""A benchmark folder of tiny cells for the CPU tests: a copy of
``gpbench/`` with small float64 configurations, mixes and limits added as
new files, and a ``BENCHMARK.json`` dict naming them."""

import json
import shutil
from pathlib import Path

import pytest
import torch

GPBENCH = Path(__file__).resolve().parent.parent
CHECKOUT = GPBENCH.parent
SEED = 2 ** 31 + 12345
# tiny cells: each real cell's mix and limits at a test's size
TINY = {"t_serve": ("lattice_serve", "tiny_lattice", "tiny_serve"),
        "t_fit": ("mt_dnb2_fit", "tiny_mt", "fit_mll_32"),
        "t_hmc": ("lattice_hmc", "tiny_lattice", "tiny_hmc")}


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """``(root, bench)``: the copied folder and the benchmark dict with the
    tiny cells appended."""
    torch.set_num_threads(2)
    return make_tiny(tmp_path_factory.mktemp("gpbench"))


def make_tiny(where):
    """Copy ``gpbench/`` into ``where`` and add the tiny cells' files."""
    root = Path(where) / "gpbench"
    shutil.copytree(GPBENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    lat = json.loads((root / "configs/lattice_d8_n20.json").read_text())
    lat.update(name="tiny_lattice", d=3, n=[512], dtype="float64")
    mt = json.loads((root / "configs/mt_dnb2.json").read_text())
    mt.update(name="tiny_mt", d=3, n=[128, 64, 32], dtype="float64")
    for c, real in ((lat, "lattice_d8_n20"), (mt, "mt_dnb2")):
        _write(root / "configs" / f"{c['name']}.json", c)
        shutil.copy(root / "yardstick/flops" / f"{real}.py",
                    root / "yardstick/flops" / f"{c['name']}.py")
    serve = json.loads((root / "traffic/serve_closed_1024.json").read_text())
    serve.update(points_per_request=32, pool_requests=4, trace_requests=2)
    _write(root / "traffic/tiny_serve.json", serve)
    hmc = json.loads((root / "traffic/hmc_chains32_fixed32.json").read_text())
    hmc.update(chains=8, num_leapfrog=4, warmup=4, iterations_per_call=4)
    _write(root / "traffic/tiny_hmc.json", hmc)
    for name, (real, cfg, mix) in TINY.items():
        shutil.copy(root / "limits" / f"{real}.json", root / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": f"the {real} cell at a test's size"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    return root, bench
