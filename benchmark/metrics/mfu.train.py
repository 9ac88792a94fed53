"""Share of the card's dense bf16 peak that the traced steps' operations
fill, the steps that card ran (rank 0's on several cards): three times
the teacher-forced forward and the frozen float32 tokenizer once, counted
against the same peak (``counts/model.py``); remat's recomputation not
counted."""

from benchmark.counts.model import train_flops_per_image
from benchmark.harness.readers import peak_pct


def read(run):
    return peak_pct(run, train_flops_per_image(run.sizes))
