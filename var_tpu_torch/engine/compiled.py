"""Compiled inference functions: the port's counterpart of ``jax.jit``.

The JAX package jits its inference programs: the sampler
(``var_tpu/engine/sampler.py:247``), the apps' decodes and tokenizers
(``apps/inpaint.py:84-88``, ``apps/smooth.py:57-61``), the classifier's
scores (``apps/classify.py:89-90``) and the analysis scores
(``apps/analysis.py:122``). :class:`Compiled` gives a body the same
contract on CUDA: the first call of an input signature runs the body
eagerly on a side stream (its result is that call's) and captures it into
a CUDA graph; later calls copy their inputs into the entry's static
buffers and replay the graph, with no host synchronisation. On the CPU the
same body runs eagerly over the same static buffers.

A body is ``fn(*modules, *inputs)`` (``fn(*modules, *inputs, generator=g)``
when it draws random numbers). Its inputs are tensors (or None); every
other argument it needs is fixed when the function is made, as JAX closes
over static arguments. It reads nothing back to the host (``.item()``,
``bool`` of a tensor, ``.cpu()``) and makes no tensor from host data
(``torch.tensor``, ``as_tensor``, ``from_numpy``): a capture refuses both.
It returns a tensor, or a tuple (named too) or list of tensors.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from var_tpu_torch.device import resolve_device


def modules_key(modules) -> tuple:
    """What a captured body is bound to: the modules, the addresses of
    their parameters and buffers (the graph reads them by pointer), and the
    TF32 switches as the caller sees them (they choose the GEMM and
    convolution kernels the graph holds)."""
    ptrs = tuple(t.data_ptr() for m in modules for t in (*m.parameters(), *m.buffers()))
    return (tuple(id(m) for m in modules), ptrs, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def signature(inputs) -> tuple:
    """The shapes and dtypes of a call's inputs (None stays None)."""
    return tuple(None if x is None else (tuple(x.shape), x.dtype) for x in inputs)


def _on_device(module: torch.nn.Module, dev: torch.device) -> bool:
    p = next(module.parameters())
    return p.device.type == dev.type and (dev.index is None or p.device.index == dev.index)


def _leaves(res) -> list:
    return [res] if isinstance(res, torch.Tensor) else list(res)


def _clone(res):
    if isinstance(res, torch.Tensor):
        return res.clone()
    leaves = [t.clone() for t in res]
    return type(res)(*leaves) if hasattr(res, "_fields") else type(res)(leaves)


class CompiledEntry:
    """One input signature of a :class:`Compiled` function, bound to the
    modules it was made with: static input buffers (``inputs``), static
    outputs (``out``: the first run's outputs), and on CUDA the ``graph``
    that replays :meth:`body` and, for a body that draws random numbers,
    the graph's own registered ``generator``.

    ``launches``: the kernel launches one run makes, by wrapper name,
    recorded at the capture (which launches nothing; each replay adds them
    to the wrappers' counts). ``capture_s``: host seconds of the capture.
    ``pool_bytes``: the memory the capture reserved (the graph's pool)."""

    def __init__(self, key: tuple, modules, inputs, fn: Callable, random: bool,
                 dev: torch.device):
        self.key, self.modules, self._fn, self._random = key, tuple(modules), fn, random
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.signature = signature(inputs)
        self.inputs = [None if x is None else torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in inputs]
        self.out = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.generator: Optional[torch.Generator] = None
        self.launches: dict = {}
        self.capture_s = 0.0
        self.pool_bytes = 0

    def load(self, inputs) -> None:
        for buf, x in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(x)

    def body(self, generator: Optional[torch.Generator] = None) -> None:
        """The function over the static buffers, into the static outputs."""
        kw = {"generator": generator} if self._random else {}
        res = self._fn(*self.modules, *self.inputs, **kw)
        if self.out is None:
            self.out = res
        else:
            for dst, src in zip(_leaves(self.out), _leaves(res)):
                dst.copy_(src)

    def capture(self, generator: Optional[torch.Generator] = None) -> None:
        """The first call on CUDA: one eager run of the body on a side
        stream, drawing from ``generator`` as the eager function would (it
        builds the kernel library, lets cuBLAS and cuDNN settle, and its
        outputs are this call's result), then the capture, drawing from the
        graph's own generator."""
        from var_tpu_torch.ops.cuda import counted_wrappers

        dev = self.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body(generator)
        main.wait_stream(side)
        for t in _leaves(self.out):  # made on the side stream, used on the main one
            t.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        if self._random:
            self.generator = torch.Generator(device=dev)
            graph.register_generator_state(self.generator)
        kernels = counted_wrappers()
        before = [fn.launches for fn in kernels]
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):  # which first empties the allocator's cache
                reserved = torch.cuda.memory_reserved(dev)
                self.body(self.generator)
        finally:  # the capture launched nothing: its counts are each replay's
            self.launches = {fn.__name__: fn.launches - n for fn, n in zip(kernels, before)}
            for fn, n in zip(kernels, before):
                fn.launches = n
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph

    def replay(self, generator: Optional[torch.Generator] = None) -> None:
        """Replay the body. A body that draws random numbers draws what the
        eager function would draw from ``generator`` (the device's default
        one when None) and advances it as the eager function would: its
        state goes into the graph's generator, whose offset the replay
        advances, and comes back. No host synchronisation."""
        from var_tpu_torch.ops.cuda import counted_wrappers

        if self._random:
            if generator is None:
                generator = torch.cuda.default_generators[self.device.index]
            self.generator.set_state(generator.get_state())
        self.graph.replay()
        if self._random:
            generator.set_state(self.generator.get_state())
        for fn in counted_wrappers():
            fn.launches += self.launches[fn.__name__]


class Compiled:
    """``fn`` compiled for ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``; raises when CUDA is asked for and absent). ``n_modules``:
    how many leading arguments are modules. ``random``: the body takes a
    ``generator`` keyword and draws from it. ``slot(*inputs)`` names the
    entry of a call in ``graphs`` (default: the inputs' signature);
    ``entry_cls`` is the entry's class.

    A call ``compiled(*modules, *inputs, generator=None)`` returns fresh
    copies of the outputs; :meth:`static` returns the entry's static
    outputs themselves (valid until the next call of that entry). A call
    whose modules, parameter addresses, TF32 switches or input signature
    differ from its entry's makes a new entry, which captures again: a
    graph never replays pointers into another model's weights. An in-place
    update of a parameter keeps the entry, and a replay reads the new
    values. A capture or replay error raises and drops the entry, so the
    next call starts afresh; nothing falls back to the eager body on
    CUDA."""

    def __init__(self, fn: Callable, n_modules: int, device="cuda", random: bool = False,
                 slot: Optional[Callable] = None, entry_cls=CompiledEntry):
        self.fn, self.n_modules, self.random = fn, n_modules, random
        self.device = resolve_device(device)
        self._slot = slot or (lambda *inputs: signature(inputs))
        self._entry_cls = entry_cls
        self.graphs: dict = {}

    def _split(self, args):
        modules, inputs = args[:self.n_modules], args[self.n_modules:]
        for m in modules:
            if not _on_device(m, self.device):
                raise ValueError(f"compiled {self.fn.__name__}: the modules must be on "
                                 f"{self.device}")
        return modules, [x if x is None or isinstance(x, torch.Tensor) else torch.as_tensor(x)
                         for x in inputs]

    def static(self, *args, generator: Optional[torch.Generator] = None):
        modules, inputs = self._split(args)
        with torch.inference_mode():
            key, slot = modules_key(modules), self._slot(*inputs)
            entry = self.graphs.get(slot)
            if entry is None or entry.key != key or entry.signature != signature(inputs):
                entry = self.graphs[slot] = self._entry_cls(key, modules, inputs, self.fn,
                                                            self.random, self.device)
            try:
                entry.load(inputs)
                if self.device.type == "cpu":
                    entry.body(generator)
                elif entry.graph is None:
                    entry.capture(generator)
                else:
                    entry.replay(generator)
            except BaseException:
                self.graphs.pop(slot, None)  # the next call starts afresh
                raise
            return entry.out

    def __call__(self, *args, generator: Optional[torch.Generator] = None):
        with torch.inference_mode():
            return _clone(self.static(*args, generator=generator))

    def eager(self, *args, generator: Optional[torch.Generator] = None):
        """The body called directly on the arguments, as the eager function
        runs: no static buffers, no graph."""
        modules, inputs = self._split(args)
        kw = {"generator": generator} if self.random else {}
        with torch.inference_mode():
            return self.fn(*modules, *inputs, **kw)
