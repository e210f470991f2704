"""Working precisions of the plain reference.

``Precision("float64")`` computes in float64: the reference that judges the
program.  ``Precision("bfloat16")`` is the control, the reference computed
one precision below the configurations' float32: every intermediate is
rounded to bfloat16 as it is produced, as bfloat16 arithmetic rounds each
result, and carried in float64 between the roundings (PyTorch has no
bfloat16 FFT; the float64 carrier also keeps a quotient by a rounded
eigenvalue near zero finite, where a float32 carrier overflows).  The eigenvalue
floor and the ridge keep the epsilon of the configuration's dtype in both
(:func:`floor_eps`), since they belong to the model as configured, not to
the arithmetic.  ``Precision("float32")`` computes natively in float32
(float32 and complex64 tensors, PyTorch's float32 FFT): the witness of what
the configurations' own precision can reach, never the judge.
"""

import torch


def floor_eps(cfg: dict) -> float:
    """The epsilon of the configuration's dtype, which the model's eigenvalue
    floor and ridge are relative to."""
    return float(torch.finfo(getattr(torch, cfg["dtype"])).eps)


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "float32", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float32 if name == "float32" else torch.float64

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to the working precision (identity in float64)."""
        if self.name == "float64":
            return t
        if self.name == "float32":
            return t.to(torch.complex64 if t.is_complex() else torch.float32)
        if t.is_complex():
            return torch.complex(self.r(t.real), self.r(t.imag))
        return t.to(torch.bfloat16).to(self.dtype)
