"""Device ms a step in the gradient all-reduce with its flatten and
copy-back: the span ``allreduce`` of ``engine/trainer.py::make_train_step``
on rank 0, over every replayed step."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without device spans
        return None
    t = span_totals().get("allreduce")
    return t.seconds / t.calls * 1e3 if t else None
