"""Device ms an image in convolution kernels: in a sampling call, the
VQVAE's render and the quantizer's phi convolutions."""

from benchmark.harness.readers import ms_per_image


def read(run):
    return ms_per_image(run, "conv")
