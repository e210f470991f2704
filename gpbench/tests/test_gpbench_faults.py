"""Each tiny cell's run on the CPU, sound and then with the timed path
broken underneath: ``correct`` comes out true for the sound run and false
for the control (the reference computed in bfloat16 in the program's place)
and for each fault the cell can have."""

import json
import time

import pytest

from gpbench import faults
from gpbench.harness import cell, registry

from .conftest import SEED

pytest.importorskip("fastgaussianprocesses_torch")


def _run(tiny, workload, seed=SEED):
    root, bench = tiny
    result, run = cell.run_cell(bench, workload, seed, 0.3, 0, "cpu", time.perf_counter(),
                                root=root)
    return result, run


@pytest.mark.parametrize("workload", ["t_serve", "t_fit", "t_hmc"])
def test_sound_run_is_correct_and_the_control_is_not(tiny, workload):
    result, run = _run(tiny, workload)
    assert result["correct"], result["compared"]
    root, bench = tiny
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = registry.config(wl["config"], root)
    drv = registry.driver(run.traffic["kind"])
    limits = registry.limits(workload, root)
    control = drv.check(run, registry.reference(cfg), control="bfloat16")
    assert any(not control[k] <= limits[k] for k in limits), control


KIND = {"t_serve": "serve", "t_fit": "fit", "t_hmc": "hmc"}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, k in KIND.items()
                                            for f in faults.FAULTS[k]],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_fault_underneath_makes_the_run_incorrect(tiny, monkeypatch, workload, fault):
    fault(monkeypatch.setattr)
    result, _ = _run(tiny, workload)
    assert not result["correct"], result["compared"]
    assert any(c["value"] is None or not c["value"] <= c["limit"]
               for c in result["compared"].values())
    json.loads(json.dumps(result), parse_constant=lambda c: pytest.fail(f"{c} in the line"))
