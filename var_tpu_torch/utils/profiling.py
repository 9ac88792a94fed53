"""One call under ``torch.profiler``, read as device events."""

from __future__ import annotations

import time


def device_events(fn) -> tuple:
    """Run ``fn()`` once under ``torch.profiler``. Returns (wall ms on the
    host clock, ending in a synchronise; the device-side events -- kernels,
    memcpy, memset, no annotation ranges -- as (name, count, self us),
    longest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.count, ev.self_device_time_total) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]
    return wall_ms, sorted(rows, key=lambda r: -r[2])
