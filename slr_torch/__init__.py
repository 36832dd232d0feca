"""slr_torch — the PyTorch/CUDA port of the slr structured-light engine.

A second package beside ``slr`` (the JAX reference). It mirrors ``slr``'s
module layout and function names, so each module's counterpart sits at the
same path, and keeps the JAX package's layouts at its public functions.
It imports torch and numpy only: never ``jax``, never ``slr``.

The hot path (``pipeline.reconstruct.reconstruct_dense``) runs one kernel
written by hand for Hopper, ``kernels/csrc/fused_scan.cu``; every other
step is plain torch.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and phase math are precision-critical (sub-mm RMS contract).
# TF32 keeps ~10 mantissa bits, which costs ~1 mm RMS on the config-3
# scene, so every float32 matmul and convolution runs in full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
