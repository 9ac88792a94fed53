"""GB of the decode's KV cache: the K and V buffers of the largest cache a
decode of the run allocated, the counter ``sampler.kv_bytes`` of
``utils/profiling.py``."""


def read(run):
    try:
        from var_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    n = counters().get("sampler.kv_bytes")
    return n / 1e9 if n else None
