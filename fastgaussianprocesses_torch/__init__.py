"""PyTorch/CUDA port of the fast Gaussian process package: O(n log n) GP
regression on lattice points and Sobol' digital nets, with hand-written
Hopper kernels for the permuted-spectrum FFT (``ops/perm_fft``,
``csrc/perm_fft.cu``) and the fast Walsh-Hadamard transform (``ops/fwht``,
``csrc/fwht.cu``).

It fits the hyperparameters of lattice and digital-net models and of the
dense ``StandardGP`` (MLL, GCV or CV with Rprop), samples their
hyperposterior by HMC (``fit/hmc``, every chain a row of the kernels), and
serves their posterior queries, with one task or many (multi-fidelity,
derivative-informed) and as ``shape_batch`` fleets; the JAX package
``fastgaussianprocesses_tpu`` is the reference it is tested against.  Entry
points run on the CUDA card unless ``device="cpu"`` is given.
"""

from . import config  # noqa: F401  (TF32 off, must come first)
from .convert import load_jax_params
from .models.digital_gp import FastGPDigitalNetB2
from .models.lattice_gp import FastGPLattice
from .models.standard_gp import StandardGP
from .points.digital_net import DigitalNetB2
from .points.halton import Halton
from .points.lattice import LatticeSeq

__all__ = ["FastGPLattice", "FastGPDigitalNetB2", "StandardGP", "LatticeSeq", "DigitalNetB2",
           "Halton", "load_jax_params", "__version__"]

__version__ = "0.1.0"
