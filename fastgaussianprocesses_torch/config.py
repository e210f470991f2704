"""Global configuration for the PyTorch/CUDA fast-GP port.

Counterpart of ``fastgaussianprocesses_tpu/config.py``:

* Models run on the CUDA card unless the caller passes ``device="cpu"``.
  With no card and no explicit CPU request, :func:`resolve_device` raises;
  nothing ever moves to the CPU on its own.
* The default dtype is float32 on CUDA and float64 on the CPU, where the
  tests hold the port against the JAX package in exact float64.
* Float32 matrix products must not round their operands: the permuted FFT's
  pass A is a matmul against a DFT table, and TF32 keeps ~3 decimal digits,
  far coarser than the ``8*eps*max|lam|`` eigenvalue floor assumes.  TF32
  is therefore switched off for matmuls and cuDNN at import, the analogue
  of the JAX package forcing ``highest`` matmul precision.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise if a CUDA device is asked for and
    none is present (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU, float32 on the card."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def debug_checks_enabled() -> bool:
    """Mirror of the JAX package's dense-oracle flag (``FASTGPS_TPU_DEBUG``),
    read from ``FASTGPS_TORCH_DEBUG``: the fast single-task solvers step
    aside for the general solver, and every solver a model builds is checked
    against the dense oracle (``utils/debug.check_fast_solver``)."""
    return os.environ.get("FASTGPS_TORCH_DEBUG", "") in ("1", "True", "true")
