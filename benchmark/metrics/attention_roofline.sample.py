"""Rows 2 and 4 (decode attention) against their roofline at the cell's
shapes: row 2's bound for one call (``counts/kernels.py::sample_rows``)
times the replays, over the seconds of the ``attention`` spans that bound
each launch, in percent. None without those spans, or when a replay holds
another number of them than a call launches."""

from benchmark.counts.kernels import sample_rows


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("attention")
    if not t or t.seconds <= 0:
        return None
    n, bound = sample_rows(run.sizes, run.traffic["batch"])["row2"]
    return 100.0 * bound * t.calls / t.seconds if t.count == n * t.calls else None
