"""The traced sub-window: ``torch.profiler`` over a few calls of the
window, its Chrome trace written under ``TMPDIR``, read back and deleted.

From the trace: the device events (kernels, memory copies and sets) inside
the window's annotation; the device's busy time as the union of their
intervals (streams overlap, so a sum of durations can pass the wall time);
the idle gaps between them, each named by the innermost host operation
running at its middle; device time by kind of kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench::traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def kind(name: str, cat: str = "kernel") -> str:
    """The kind a device event's time is counted under: the program's
    kernel rows (``PERF.md``'s table), ``nccl``, ``memcpy``, ``conv``
    (cuDNN, FFT plans included), ``gemm``, else ``elementwise`` (PyTorch's
    elementwise, reduction, indexing and optimizer kernels)."""
    if cat != "kernel":
        return "memcpy"
    n = name.lower()
    row = "row5" if "<5>" in n or "ili5e" in n else "row6"
    if "nccl" in n:
        return "nccl"
    if "modulated_ln" in n:
        return "row1"
    if "decode_attention" in n:
        return "row4" if "<true" in n else "row2"
    if "topk_topp_bound" in n:
        return "row3"
    if "ptrain_fwd" in n:
        return f"{row}_fwd"
    if "ptrain_dq" in n:
        return f"{row}_bwd"
    if "ptrain_dkv" in n or "train_delta" in n:
        return f"{row}_bwd_dkv"
    if "gn_stats" in n:
        return "row7"
    if any(w in n for w in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "fft", "winograd",
                            "dse::", "pointwise_mult_and_sum_complex", "flip_filter")):
        return "conv"
    if any(w in n for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas", "matmul")):
        return "gemm"
    return "elementwise"


@dataclass
class Trace:
    """What the readers of ``benchmark/metrics`` take from one traced
    sub-window of ``calls`` calls and ``images`` images."""

    window_s: float
    busy_s: float
    calls: int = 0
    images: int = 0
    kind_s: Dict[str, float] = field(default_factory=dict)
    kind_n: Dict[str, int] = field(default_factory=dict)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(events: List[dict]) -> Trace:
    """A :class:`Trace` from Chrome-trace events (times in microseconds)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no window annotation")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _merge((e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev)
    kind_s, kind_n, by_name = defaultdict(float), defaultdict(int), defaultdict(float)
    for e in dev:
        k = kind(e["name"], e["cat"])
        kind_s[k] += e["dur"] * 1e-6
        kind_n[k] += 1
        by_name[e["name"]] += e["dur"] * 1e-6
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        cover = [e for e in host if e["ts"] <= mid < e["ts"] + e["dur"]]
        name = min(cover, key=lambda e: e["dur"])["name"] if cover else "host, outside any op"
        idle[name] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kind_s=dict(kind_s), kind_n=dict(kind_n), top_ops=top,
                 idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1])[:10])


class Profiled:
    """``with Profiled() as p: ...`` traces the block (the caller
    synchronises inside it); ``p.read()``, once the window has closed,
    gives its :class:`Trace` (None when not ``enabled``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.enabled:
            return self
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._rf = record_function(WINDOW)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._rf.__exit__(*exc)
            self._prof.__exit__(*exc)
        return False

    def read(self):
        if not self.enabled:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        return read(events)
