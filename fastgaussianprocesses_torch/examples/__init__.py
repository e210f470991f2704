"""Runnable examples of the port, counterparts of the JAX package's
``examples/`` scripts: each ``main(..., device=None)`` runs on the CUDA card
unless ``device="cpu"`` is given, keeps the JAX example's checks and returns
True.  Run one as ``python -m fastgaussianprocesses_torch.examples.simple``."""
