"""PyTorch/CUDA port of the GastCoCo reproduction (``repro``).

Module names mirror the JAX package.  Entry points run on the CUDA device
unless the caller names another one; the ``combine="sum"`` sweeps go
through hand-written Hopper kernels (``repro_torch/csrc``).
"""
