"""PyTorch/CUDA port of differentialriccatiequations_jl_tpu.

Mirrors the JAX package's module names.  Imports torch, numpy and scipy,
never JAX.  Banded (DIA) products run through the hand-written CUDA kernel
in ``csrc/dia_spmm.cu``, block-ELL products through ``csrc/bell_spmm.cu``,
on CUDA tensors, and through their plain PyTorch versions on CPU tensors.
"""

from . import config  # noqa: F401  (switches TF32 off)
