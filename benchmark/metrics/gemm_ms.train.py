"""Device ms an image in GEMM kernels (cuBLAS, CUTLASS)."""

from benchmark.harness.readers import ms_per_image


def read(run):
    return ms_per_image(run, "gemm")
