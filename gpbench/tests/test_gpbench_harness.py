"""The harness: parts found by name (a dummy configuration, mix and
per-layer metric added as new files), the result line's schema, the import
guard, what the benchmark reads, and ``BENCHMARK.json`` against the
limits of its format."""

import hashlib
import json
import re
import subprocess
import sys
import time

import pytest

from gpbench.harness import cell, guard

from .conftest import CHECKOUT, GPBENCH, SEED, _write

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_dummy_parts_are_found_by_name(tiny):
    root, bench = tiny
    before = _digests(root)
    cfg = json.loads((root / "configs/tiny_lattice.json").read_text())
    cfg.update(name="dummy_lattice", d=2, n=[256])
    _write(root / "configs/dummy_lattice.json", cfg)
    _write(root / "traffic/dummy_serve.json",
           {"kind": "serve", "points_per_request": 8, "pool_requests": 2,
            "check_requests": 1, "trace_requests": 2})
    _write(root / "limits/t_dummy.json", {"mean_gap": 1e-3, "var_gap": 1e-3})
    (root / "yardstick/flops/dummy_lattice.py").write_text(
        '"""A dummy count."""\n\n\ndef serve_request_flops(cfg, N):\n'
        '    return 1e9 * N\n')
    (root / "metrics/dummy_requests.serve.py").write_text(
        '"""Requests in the traced window."""\n\n\ndef read(ctx):\n'
        '    return ctx.work["requests"]\n')
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "t_dummy", "config": "dummy_lattice",
                               "traffic": "dummy_serve", "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_requests.serve", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "request", "moves": "serve_points_per_s",
                               "workloads": ["t_dummy"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_points_per_s", "mfu.serve"):
            m["workloads"].append("t_dummy")
    result, run = cell.run_cell(bench, "t_dummy", SEED, 5.0, 1, "cpu", time.perf_counter(),
                                root=root)
    assert result["metrics"]["dummy_requests.serve"] == {"value": 2.0, "unit": "requests"}
    # the configuration's own count: 2 requests of 8 points at 1e9 FLOP a point
    mfu = result["metrics"]["mfu.serve"]["value"]
    assert mfu == pytest.approx(100 * 16e9 / (run.trace.window_s * 67e12), rel=0.5)
    assert result["correct"], result["compared"]
    after = _digests(root)
    assert all(after[p] == h for p, h in before.items()), "an existing file changed"


def test_result_line_schema(tiny):
    root, bench = tiny
    result, _ = cell.run_cell(bench, "t_serve", SEED, 0.3, 0, "cpu", time.perf_counter(),
                              root=root)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert isinstance(result["correct"], bool) and result["attempted"] >= 1
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "serve_points_per_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["compared"]) == {"mean_gap", "var_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["compared"].values())
    json.loads(json.dumps(result))


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "numpy",
                                    "fastgaussianprocesses_torch.ops",
                                    "fastgaussianprocesses_tpu.models", "jaxtyping"]) == [
        "fastgaussianprocesses_tpu", "flax", "jax", "jaxlib"]
    assert guard.forbidden_modules(["fastgaussianprocesses_torch", "gpbench.harness"]) == []


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from gpbench.harness import cell, guard\n"
            "from gpbench.tests.conftest import make_tiny\n"
            "root, bench = make_tiny(%r)\n"
            "res, _ = cell.run_cell(bench, 't_serve', 1, 0.2, 0, 'cpu', time.perf_counter(), "
            "root=root)\n"
            "print(res['correct'], guard.forbidden_modules())\n") % (str(CHECKOUT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_sources_read_no_jax_and_no_old_benchmark():
    srcs = [p for p in GPBENCH.rglob("*.py") if "tests" not in p.parts]
    for p in srcs:
        text = p.read_text()
        for word in ("bench.py", "chip_smoke", "BENCH_", "import jax", "from jax"):
            assert word not in text, (p, word)
        # the guard names the JAX package; nothing else does
        assert p.name == "guard.py" or "fastgaussianprocesses_tpu" not in text, p
    for p in (GPBENCH / "reference").glob("*.py"):
        assert "fastgaussianprocesses_torch" not in p.read_text(), p


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", "lattice_serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=CHECKOUT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_to_its_format():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["gpbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (CHECKOUT / c["file"]).is_file() and c["file"].startswith("gpbench/")
        assert json.loads((CHECKOUT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (GPBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (GPBENCH / "limits" / f"{w['name']}.json").is_file()
        assert w["config"] in {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (GPBENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(b)) <= 64 * 1024
