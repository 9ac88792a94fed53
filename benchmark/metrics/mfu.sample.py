"""Share of the card's dense bf16 peak that the traced decodes' operations
fill: the transformer's products for the guided and unguided rows,
attention over the cache, the head, the render, its float32 parts counted
against the same peak (``counts/model.py``)."""

from benchmark.counts.model import sample_flops_per_image
from benchmark.harness.readers import peak_pct


def read(run):
    return peak_pct(run, sample_flops_per_image(run.sizes))
