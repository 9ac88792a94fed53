"""Device ms an image in convolution kernels: in a training step, the
frozen VQVAE encoder's and the quantizer's alone (the transformer has
none)."""

from benchmark.harness.readers import ms_per_image


def read(run):
    return ms_per_image(run, "conv")
