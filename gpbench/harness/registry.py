"""Finds a cell's parts by name: configurations in ``configs/<name>.json``,
traffic mixes in ``traffic/<name>.json``, each cell's limits of
correctness in ``limits/<workload>.json``, per-layer metric readers in
``metrics/<name>.py``, the traffic kind's driver in ``harness/<kind>.py``,
the configuration's plain reference in ``reference/`` and the FLOPs of its
steps in ``yardstick/flops/<configuration>.py``.  ``root`` is the
benchmark's folder; tests pass a copy of it with files added."""

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _json(root, folder, name):
    path = Path(root) / folder / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def config(name, root=ROOT):
    return _json(root, "configs", name)


def traffic(name, root=ROOT):
    return _json(root, "traffic", name)


def limits(workload, root=ROOT):
    return _json(root, "limits", workload)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name, root=ROOT):
    """The reader module of per-layer metric ``name``."""
    return _module(Path(root) / "metrics" / f"{name}.py",
                   f"gpbench_metric_{name.replace('.', '_')}")


def flops(config_name, root=ROOT):
    """The module of FLOP counts of configuration ``config_name``'s steps,
    or None where it has none."""
    path = Path(root) / "yardstick" / "flops" / f"{config_name}.py"
    return _module(path, f"gpbench_flops_{config_name}") if path.is_file() else None


def driver(kind):
    """The driver module of a traffic ``kind`` (``serve``, ``fit``, ``hmc``)."""
    return importlib.import_module(f"gpbench.harness.{kind}")


def reference(cfg):
    """The plain reference class that a configuration's ``reference`` names,
    ``"<module of gpbench.reference>.<class>"``."""
    mod, cls = cfg["reference"].rsplit(".", 1)
    return getattr(importlib.import_module(f"gpbench.reference.{mod}"), cls)
