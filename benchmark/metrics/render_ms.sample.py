"""Device ms an image in the VQVAE render (``render_fhat``): the span
``render`` of ``engine/sampler.py``, over every replay of the run."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("render")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
