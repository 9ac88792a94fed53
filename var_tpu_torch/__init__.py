"""PyTorch/CUDA port of ``var_tpu``: VAR class-conditional sampling on NVIDIA
Hopper.

The JAX package ``var_tpu`` is the reference; this package mirrors its module
names (``config``, ``ops``, ``models``, ``engine``, ``apps``) so each function
has a counterpart there. It imports ``torch`` and never ``jax`` or
``var_tpu``. The TPU Pallas kernels on the sampling path are hand-written
CUDA C++ kernels under ``ops/cuda/csrc``, built with ``nvcc`` at first use.
Entry points run on the GPU unless the caller asks for the CPU.
"""
