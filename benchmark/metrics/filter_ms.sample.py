"""Device ms an image at row 3's call site: the top-k/top-p draw, the keep
mask and the codebook lookup (the span ``filter`` of
``engine/sampler.py``), over every replay of the run."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("filter")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
