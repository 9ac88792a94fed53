"""Host ms a call of the compiled sampler, from entry to return (inputs,
load, replay launch, output copies), over the calls that replayed: the
counters ``sampler.host_s`` and ``sampler.calls`` of
``utils/profiling.py``."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    return c["sampler.host_s"] / c["sampler.calls"] * 1e3 if c["sampler.calls"] else None
