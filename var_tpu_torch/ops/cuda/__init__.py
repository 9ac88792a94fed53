"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper routes by device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. ``launches`` on each wrapper counts
kernel launches and nothing else.
"""
