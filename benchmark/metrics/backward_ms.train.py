"""Device ms an image in the backward: the span ``backward`` of
``engine/trainer.py::make_train_step``, over every replayed step."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("backward")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
