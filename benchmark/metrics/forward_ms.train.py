"""Device ms an image in the teacher-forced forward and its loss
(``teacher_loss``): the span ``forward`` of
``engine/trainer.py::make_train_step``, over every replayed step."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("forward")
    return t.seconds / t.calls / run.traffic["batch"] * 1e3 if t else None
