"""Rows 1-3 of the kernel table (LayerNorm, decode attention, top-k/top-p
bound) in the traced decodes: their summed bounds at the cell's shapes
(``counts/kernels.py``) over their summed device time, in percent."""

from benchmark.counts.kernels import sample_rows
from benchmark.harness.readers import roofline_pct

PARTS = {"row1": ("row1",), "row2": ("row2",), "row3": ("row3",)}


def read(run):
    return roofline_pct(run, sample_rows(run.sizes, run.traffic["batch"]), PARTS)
