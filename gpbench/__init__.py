"""The benchmark of the PyTorch/CUDA port (``fastgaussianprocesses_torch``)."""
