"""mpmc_tpu_torch — the PyTorch/CUDA port of mpmc_tpu.

The same rigid-molecule Monte Carlo (MPMC capabilities) on one NVIDIA
H100: plain PyTorch for the array code around the kernels, and
hand-written CUDA C++ for the kernels the JAX package wrote in Pallas
(``ops/cuda``, sources in ``csrc/``).  Module layout and names follow
``mpmc_tpu`` so each counterpart is easy to find; ``mpmc_tpu`` stays the
reference the port is held against.

This package imports torch and never jax.  The framework-free host
modules (constants, the input-script parser, PQR I/O, output writers,
fugacity EoS, averages, histograms) are copies, because importing any
``mpmc_tpu`` module runs ``mpmc_tpu/__init__.py``, which imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Reduced-precision (TF32) contractions keep ~3 decimal digits: on
# coordinates (a min-image transform or an Ewald phase k.r through a
# matmul) that corrupts every energy at the 1e-3 level — the reason
# mpmc_tpu/__init__.py pins f32 matmul precision.  Physics code needs
# true f32 contractions everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from mpmc_tpu_torch import constants  # noqa: E402,F401
