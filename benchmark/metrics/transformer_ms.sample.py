"""Device ms an image in the decode's transformer stages (rows 1 and 2, the
GEMMs around them): the span ``transformer`` of ``engine/sampler.py``, over
every replay of the run."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("transformer")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
