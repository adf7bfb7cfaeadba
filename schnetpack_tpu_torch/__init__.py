"""schnetpack_tpu_torch: the PyTorch/CUDA port of schnetpack_tpu.

The JAX package ``schnetpack_tpu`` is the reference; this package mirrors
its module paths and runs the PaiNN column-layout MD path on an NVIDIA
Hopper GPU through hand-written CUDA kernels (``csrc/``), with plain
PyTorch twins of every kernel for CPU tensors; the flat and dense layouts,
and training on them, are plain PyTorch.  It imports neither jax nor
schnetpack_tpu.

Precision is f32 throughout: TF32 is switched off for matmuls and cuDNN.
"""
import torch

from . import properties, units

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["properties", "units"]
