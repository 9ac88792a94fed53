"""Device ms an image in the decode's heads (``get_logits_cfg``: the CFG
mix and the fp32 head): the span ``head`` of ``engine/sampler.py``, over
every replay of the run."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("head")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
