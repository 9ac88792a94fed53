"""Device ms a step in NCCL kernels (the gradient all-reduce and the
metrics' mean) on rank 0, overlapping or not."""


def read(run):
    tr = run.trace
    if tr is None or "nccl" not in tr.kind_n:
        return None
    return tr.kind_s["nccl"] / tr.calls * 1e3
