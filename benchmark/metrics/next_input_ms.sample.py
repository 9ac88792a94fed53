"""Device ms an image in the quantizer's f_hat update and the next scale's
input (``get_next_autoregressive_input``, ``_next_input``): the span
``next_input`` of ``engine/sampler.py``, over every replay of the run."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("next_input")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
