"""CUDA graphs the run's compiled programs captured, replaced and dropped
ones too: the counter ``compiled.captures`` of ``utils/profiling.py``."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    return counters()["compiled.captures"] or None
