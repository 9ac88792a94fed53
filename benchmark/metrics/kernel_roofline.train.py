"""Row 6 of the kernel table (the paired block-causal training attention)
in the traced steps: its forward and backward launches' summed bounds at
the cell's shapes (``counts/kernels.py``) over their device time, in
percent."""

from benchmark.counts.kernels import train_rows
from benchmark.harness.readers import roofline_pct

PARTS = {"row6_fwd": ("row6_fwd",), "row6_bwd": ("row6_bwd", "row6_bwd_dkv")}


def read(run):
    return roofline_pct(run, train_rows(run.sizes, run.traffic["batch"],
                                        run.traffic["remat"]), PARTS)
