"""The port's examples (``fastgaussianprocesses_torch/examples``) at
``tests/test_examples.py``'s sizes, on the CPU; the hyperposterior example
runs in ``tests/test_torch_hmc.py``."""

import importlib

import pytest

pytest.importorskip("torch")


@pytest.mark.parametrize("name,kwargs", [
    ("simple", dict(n=1 << 8, iterations=10)),
    ("multitask", dict(n_hi=1 << 5, iterations=10)),
    ("batch_multitask", dict(B=2, n=1 << 6, iterations=6)),
    ("derivative_informed", dict(n=1 << 6, iterations=10)),
])
def test_example(name, kwargs):
    mod = importlib.import_module(f"fastgaussianprocesses_torch.examples.{name}")
    assert mod.main(device="cpu", **kwargs) is True
