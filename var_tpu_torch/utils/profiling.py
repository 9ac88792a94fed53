"""The port's tracing: spans inside its compiled programs, host spans and
counters around each call, and one call under ``torch.profiler`` read as
device events.

**Device spans.** A compiled program (``engine/compiled.py``) replays one
CUDA graph, inside which the host runs nothing, so its layers are bounded on
the device. :func:`span`, placed in a program's body at a layer boundary,
puts a one-thread stamp kernel (``ops/cuda/csrc/span_stamp.cu``, named
``var_span_stamp_kernel`` on a profiler's timeline) into the graph while a
:class:`Recording` records the capture; each stamp writes the device's
``%globaltimer`` (ns) to the device's ring of :data:`SLOTS` int64. Stamps
mark boundaries: a span's start is the stamp before it when another span
entered or exited before it (work between two spans counts to the later
one), and its end is the stamp of an exit right before it; the outermost
span, named by the program, always starts and ends on stamps of its own.
Such layer-boundary spans tile their parent. A span made with ``own=True``
instead bounds exactly the work inside it, nested in a layer (the decode's
``attention`` around each cached-attention launch): it starts and ends on
stamps of its own, and the next span event after either of them stamps
anew too, so its neighbours' boundaries stay where they were without it
and the work between it and them stays theirs. At
the capture the host records the program's :class:`Layout` (its spans'
names, nesting and stamps); at each replay, where in the ring the replay
starts and its call id (the replay's index, :data:`COUNTERS`'
``compiled.replays`` before it). A replay writes a fixed number of stamps,
so nothing is read back until :func:`spans`. Only replays write stamps: a
first call's eager run writes none. A device's replays run one after
another (on one stream, as the port issues them), so each replay's stamps
are consecutive. A ring lives as long as the process, since every graph
holds its address.

**Host spans.** Outside a recorded capture :func:`span` is a
``record_function`` range, entered only while a profiler is active; with
neither it costs a flag check. The ranges land in the same trace as the
device's events.

**Counters.** :data:`COUNTERS`, always on: plain host numbers.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

SLOTS = 1 << 20  # stamps a device's ring holds (8 MiB)

COUNTERS: Dict[str, float] = {
    "compiled.calls": 0,  # calls of a compiled program, on any device
    "compiled.captures": 0,  # CUDA graphs captured, replaced or dropped ones too
    "compiled.capture_s": 0.0,  # host seconds of those captures
    "compiled.replays": 0,
    "sampler.calls": 0,  # make_sampler's calls that replayed ...
    "sampler.host_s": 0.0,  # ... and their host seconds from entry to return
    "sampler.kv_bytes": 0,  # bytes of the K and V buffers of the largest decode cache made
    "train.steps": 0,  # make_train_step's steps that replayed ...
    "train.host_s": 0.0,  # ... and theirs
}


def counters() -> Dict[str, float]:
    """A copy of the counter table."""
    return dict(COUNTERS)


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span's name; None for a program's own
    call: int  # the replay's id: the spans of one replay share it
    device: int
    start_ns: int  # the device's %globaltimer
    end_ns: int


class Total(NamedTuple):
    seconds: float
    count: int  # spans of the name
    calls: int  # replays holding one at least


@dataclass
class Layout:
    """The stamps a captured program writes each replay: ``n`` of them, and
    each span as [name, parent's index (-1: none), start stamp, end stamp]."""

    n: int = 0
    spans: list = field(default_factory=list)


class _Ring:
    """A device's stamps: ``buf``, ``pos`` (the count the device wrote),
    ``head`` (the count the recorded replays make) and ``replays`` (layout,
    start, call) of the replays whose stamps ``buf`` still holds."""

    def __init__(self, dev: torch.device):
        self.device = dev
        with torch.inference_mode(False):  # plain tensors, whichever program captures first
            self.buf = torch.zeros(SLOTS, dtype=torch.int64, device=dev)
            self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        torch.cuda.synchronize(dev)  # zeroed before any stream replays a stamp
        self.head = 0
        self.replays: deque = deque()

    def stamp(self) -> None:
        from var_tpu_torch.ops.cuda import build

        rc = build.lib().var_span_stamp(self.buf.data_ptr(), self.pos.data_ptr(), SLOTS,
                                        self.device.index,
                                        torch.cuda.current_stream(self.device).cuda_stream)
        build.check(rc, "span_stamp")

    def record(self, layout: Layout, call: int) -> None:
        self.replays.append((layout, self.head, call))
        self.head += layout.n
        while self.replays[0][1] < self.head - SLOTS:  # overwritten
            self.replays.popleft()


_RINGS: Dict[int, _Ring] = {}
_recording: Optional["Recording"] = None


class span:
    """``with span(name): ...`` around a layer of a program's body: its
    device span while a :class:`Recording` records the capture, else a host
    ``record_function`` range (``args``: a string shown with it) while a
    profiler is active, else nothing. ``own``: the device span starts and
    ends on stamps of its own (see the module docstring)."""

    __slots__ = ("name", "args", "own", "_rec", "_rf")

    def __init__(self, name: str, args: Optional[str] = None, own: bool = False):
        self.name, self.args, self.own, self._rec, self._rf = name, args, own, None, None

    def __enter__(self):
        if _recording is not None:
            self._rec = _recording
            self._rec.enter(self.name, self.own)
        elif _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function(self.name, self.args)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            if exc[0] is None:  # a failed capture is dropped with its layout
                self._rec.exit()
        elif self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class Recording:
    """The device spans of one capture. Made before ``torch.cuda.graph``
    (it makes ``device``'s ring there, outside the graph's pool) and entered
    inside it around the body, which it wraps in the span ``name``; then
    ``layout`` holds what each replay writes. ``launch`` puts one stamp into
    the graph (default: the stamp kernel on ``device``'s current stream)."""

    def __init__(self, device: torch.device, name: str,
                 launch: Optional[Callable[[], None]] = None):
        if launch is None:
            if device.index not in _RINGS:
                _RINGS[device.index] = _Ring(device)
            launch = _RINGS[device.index].stamp
        self.name, self._launch, self.layout = name, launch, Layout()
        self._stack: List[Tuple[int, bool]] = []  # (index in layout.spans, own)
        self._last: Optional[str] = None  # the last span event; None: the next stamps anew
        self._root = span(name)

    def __enter__(self) -> Layout:
        global _recording
        if _recording is not None:
            raise RuntimeError("span recording: a capture is being recorded already")
        _recording = self
        self._root.__enter__()
        return self.layout

    def __exit__(self, *exc):
        global _recording
        try:
            if exc[0] is None:
                self._root.__exit__(None, None, None)
        finally:
            _recording = None
        return False

    def _stamp(self) -> int:
        self._launch()
        self.layout.n += 1
        return self.layout.n - 1

    def enter(self, name: str, own: bool = False) -> None:
        k = self._stamp() if own or self._last is None else self.layout.n - 1
        parent = self._stack[-1][0] if self._stack else -1
        self._stack.append((len(self.layout.spans), own))
        self.layout.spans.append([name, parent, k, -1])
        self._last = None if own else "enter"

    def exit(self) -> None:
        i, own = self._stack.pop()
        shared = not own and self._last == "exit" and self._stack
        self.layout.spans[i][3] = self.layout.n - 1 if shared else self._stamp()
        self._last = None if own else "exit"


def replayed(layout: Optional[Layout], device: torch.device) -> None:
    """Count one replay of a captured program and, when it writes stamps,
    record where they land."""
    call = COUNTERS["compiled.replays"]
    COUNTERS["compiled.replays"] = call + 1
    if layout is not None and layout.n:
        _RINGS[device.index].record(layout, call)


def rebuild(buf: np.ndarray, head: int, replays: Iterable, device: int) -> List[Span]:
    """The spans of ``replays`` ((layout, start, call) each) from ``buf``, a
    ring of ``len(buf)`` slots into which ``head`` stamps have been written;
    a replay whose stamps were overwritten is left out."""
    slots, out = len(buf), []
    for layout, start, call in replays:
        if start < head - slots:
            continue
        t = buf[(start + np.arange(layout.n)) % slots]
        names = layout.spans
        out += [Span(name, names[parent][0] if parent >= 0 else None, call, device,
                     int(t[a]), int(t[b])) for name, parent, a, b in names]
    return out


def spans() -> List[Span]:
    """Every recorded replay's spans, its devices' rings copied back once."""
    out = []
    for idx, ring in _RINGS.items():
        torch.cuda.synchronize(idx)
        pos = int(ring.pos.item())
        if pos != ring.head:
            raise RuntimeError(f"span ring of cuda:{idx}: {pos} stamps written where the "
                               f"recorded replays make {ring.head}; a graph with stamps was "
                               "replayed outside engine/compiled.py")
        out += rebuild(ring.buf.cpu().numpy(), ring.head, ring.replays, idx)
    return out


def span_totals(items: Optional[Iterable[Span]] = None) -> Dict[str, Total]:
    """Each span name's total seconds, count and calls, over ``items``
    (default: :func:`spans`)."""
    acc: dict = {}
    for s in spans() if items is None else items:
        a = acc.setdefault(s.name, [0, 0, set()])
        a[0] += s.end_ns - s.start_ns
        a[1] += 1
        a[2].add((s.device, s.call))
    return {n: Total(ns * 1e-9, c, len(calls)) for n, (ns, c, calls) in acc.items()}


class call:
    """One call of a program on the host: the span ``name`` (its args: the
    call id its replay takes); when the call replayed a graph, its host
    seconds from entry to return go to ``COUNTERS[host_s]`` and
    ``COUNTERS[calls]`` counts it."""

    __slots__ = ("name", "calls", "host_s", "_span", "_n", "_t0")

    def __init__(self, name: str, calls: str, host_s: str):
        self.name, self.calls, self.host_s = name, calls, host_s

    def __enter__(self):
        self._n = COUNTERS["compiled.replays"]
        self._span = span(self.name,
                          str(self._n) if _autograd_profiler._is_profiler_enabled else None)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        if exc[0] is None and COUNTERS["compiled.replays"] > self._n:
            COUNTERS[self.calls] += 1
            COUNTERS[self.host_s] += dt
        return False


def reset() -> None:
    """Zero the counters and forget the recorded replays; the rings stay
    (graphs hold their addresses), their host counts set to the devices'."""
    for k in COUNTERS:
        COUNTERS[k] = type(COUNTERS[k])(0)
    for idx, ring in _RINGS.items():
        torch.cuda.synchronize(idx)
        ring.head = int(ring.pos.item())
        ring.replays.clear()


def device_events(fn) -> tuple:
    """Run ``fn()`` once under ``torch.profiler``. Returns (wall ms on the
    host clock, ending in a synchronise; the device-side events -- kernels,
    memcpy, memset, no annotation ranges -- as (name, count, self us),
    longest first)."""
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
