"""Device ms an image in the decode's cached attention (row 2, or row 4
over a paired cache): the span ``attention`` that ``models/var.py::attn_apply``
puts around the kernel's launch alone, over every replay of the run."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("attention")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
