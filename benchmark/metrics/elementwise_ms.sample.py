"""Device ms an image in PyTorch's elementwise, reduction, indexing and
optimizer kernels: none of the convolutions, GEMMs, the program's kernel
rows, memory copies or NCCL."""

from benchmark.harness.readers import ms_per_image


def read(run):
    return ms_per_image(run, "elementwise")
