"""Device ms an image in the step's frozen tokenizer: the span ``tokenize``
of ``engine/trainer.py::make_train_step``, over every replayed step."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("tokenize")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
