"""Host ms a training step, from entry to return (the schedule and its
scalars, load, replay launch), over the steps that replayed: the counters
``train.host_s`` and ``train.steps`` of ``utils/profiling.py``."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    return c["train.host_s"] / c["train.steps"] * 1e3 if c["train.steps"] else None
