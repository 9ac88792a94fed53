"""The port's tracing (``utils/profiling.py``) on the CPU: the stamp layout
a capture records and the spans rebuilt from a ring, host ranges only under
a profiler, the layers the sampler and the training step mark, the
counters, and the benchmark's readers of them. A captured program's stamps
run only on the card (``tests/test_torch_cuda.py``)."""

import collections
import copy
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import profile

from benchmark.harness.registry import Registry
from var_tpu_torch.apps import dryrun_multigpu as dry
from var_tpu_torch.config import TrainArgs
from var_tpu_torch.engine import sampler as tsm
from var_tpu_torch.engine import trainer as tr
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.utils import profiling
from var_tpu_torch.utils.profiling import Layout, Recording, Span, span

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SPEC = dry.tiny_spec(1, "cpu", "gloo")  # depth 2, C 64, V 64, pn 1_2_3, batch 2
CPU = torch.device("cpu")
SAMPLE_SPANS = ("start", "transformer", "head", "filter", "next_input", "render")
TRAIN_SPANS = ("tokenize", "forward", "backward", "optimizer", "metrics")


@pytest.fixture(scope="module")
def models():
    return dry.build_models(SPEC, CPU)


def _recorded(fn, name="prog"):
    """(layout, stamps launched) of ``fn()`` run under a recording."""
    launched = []
    with Recording(CPU, name, launch=lambda: launched.append(1)) as layout:
        fn()
    return layout, len(launched)


def _nested():
    with span("a"):
        pass
    with span("b"):
        with span("b1"):
            pass
        with span("b2"):
            pass
    with span("c"):
        pass


def test_stamps_are_shared_boundaries_and_the_program_has_its_own():
    layout, launched = _recorded(_nested)
    assert launched == layout.n == 6
    assert layout.spans == [["prog", -1, 0, 5], ["a", 0, 0, 1], ["b", 0, 1, 3],
                            ["b1", 2, 1, 2], ["b2", 2, 2, 3], ["c", 0, 3, 4]]


def test_spans_rebuild_from_a_ring_that_wrapped():
    layout, _ = _recorded(_nested)
    slots = 8
    stamp = lambda p: 1000 * p * p + 7  # noqa: E731  (distinct, growing)
    buf = np.zeros(slots, np.int64)
    for p in range(12):  # two replays of 6 stamps: the second wraps over the first
        buf[p % slots] = stamp(p)
    got = profiling.rebuild(buf, 12, [(layout, 0, 5), (layout, 6, 6)], device=3)
    assert {s.call for s in got} == {6}
    by = {s.name: s for s in got}
    assert by["prog"] == Span("prog", None, 6, 3, stamp(6), stamp(11))
    assert [by[n].parent for n in ("a", "b", "b1", "b2", "c")] == ["prog", "prog", "b", "b",
                                                                   "prog"]
    assert (by["a"].end_ns, by["b"].start_ns, by["b1"].start_ns) == (stamp(7),) * 3
    assert (by["b2"].end_ns, by["b"].end_ns, by["c"].start_ns) == (stamp(9),) * 3
    twice = got + [s._replace(call=7) for s in got]
    tot = profiling.span_totals(twice)
    assert tot["b"] == pytest.approx((2 * (stamp(9) - stamp(7)) * 1e-9, 2, 2))
    assert set(tot) == {"prog", "a", "b", "b1", "b2", "c"}
    kept = profiling.rebuild(buf[:6].copy(), 6, [(layout, 0, 5)], device=0)
    assert [s.call for s in kept] == [5] * 6


def test_a_ring_forgets_the_replays_it_overwrote():
    ring = object.__new__(profiling._Ring)
    ring.head, ring.replays = 0, collections.deque()
    half = Layout(n=profiling.SLOTS // 2)
    for call in range(4):
        ring.record(half, call)
    assert ring.head == 2 * profiling.SLOTS
    assert [c for _, _, c in ring.replays] == [2, 3]


def test_a_span_is_a_host_range_only_under_a_profiler(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refused)
    with span("quiet"):
        torch.ones(2).add_(1)
    monkeypatch.undo()
    with profile() as prof:
        with span("traced", "7"):
            torch.ones(2).add_(1)
    assert "traced" in {e.name for e in prof.events()}


def _tiny_sample(models):
    vae, var = models
    var = var.eval()
    with torch.inference_mode():
        return tsm.decode_cfg(var, vae, torch.tensor([1, 7]), torch.Generator().manual_seed(0),
                              cfg_scale=1.5, top_k=4, top_p=0.9, dtype=torch.float32)


def _tiny_step(models):
    """(step, its state, (imgs, labels)) of a copy of the tiny VAR."""
    vae, var = models
    var = copy.deepcopy(var).train()
    args = TrainArgs(**dict(SPEC["args"], bs=SPEC["batch"], ac=1)).finalize(world_size=1)
    init_state, step = tr.make_train_step(var.cfg, vae.cfg, args, 4, dtype=torch.float32,
                                          attn_impl="xla")
    imgs, labels = dry._batch(SPEC, 1, var.cfg.patch_nums[-1] * vae.cfg.downsample)
    return step, init_state(var), (torch.from_numpy(imgs), torch.from_numpy(labels))


def test_the_decode_and_the_step_show_their_spans_under_a_profiler(models):
    with profile() as prof:
        _tiny_sample(models)
    assert set(SAMPLE_SPANS) <= {e.name for e in prof.events()}
    vae, _ = models
    step, state, x = _tiny_step(models)
    with profile() as prof:
        step(state, vae, *x, torch.Generator().manual_seed(0), 0, 1.0)
    names = {e.name for e in prof.events()}
    assert set(TRAIN_SPANS) | {"train.step", "train.hyper", "compiled.load"} <= names


def test_a_decode_and_a_step_record_one_stamp_a_boundary(models):
    """Recorded as a capture records them: the decode's spans tile it (each
    starts where the one before it ended), four stamps a stage and four
    more; the step's five layers take seven."""
    layout, launched = _recorded(lambda: _tiny_sample(models), "sample")
    stages = len(SPEC["var"]["patch_nums"])
    names = [s[0] for s in layout.spans]
    assert names == ["sample", "start", *["transformer", "head", "filter",
                                          "next_input"] * stages, "render"]
    assert launched == layout.n == 4 * stages + 4
    assert all(cur[2] == prev[3] for prev, cur in zip(layout.spans[1:], layout.spans[2:]))
    assert all(s[1] == 0 for s in layout.spans[1:])
    vae, _ = models
    step, state, (imgs, labels) = _tiny_step(models)
    hyper = torch.tensor([1e-4, 0.05, 1.0])
    layout, launched = _recorded(lambda: step.program.eager(
        state, vae, imgs, labels, hyper, generator=torch.Generator().manual_seed(0)),
        "train_step")
    assert [s[0] for s in layout.spans] == ["train_step", *TRAIN_SPANS]
    assert launched == layout.n == 7


def test_counters_of_programs_on_the_cpu(models):
    """On the CPU a compiled program runs its body eagerly: its calls
    count, and no capture or replay does; a sampler call that replayed
    nothing adds no host time; each call's float32 render counts its
    decoder's GroupNorms on the plain path."""
    profiling.reset()
    lin = torch.nn.Linear(2, 2)
    prog = Compiled(lambda m, x: m(x), 1, "cpu")
    for _ in range(3):
        prog(lin, torch.ones(1, 2))
    vae, var = models
    sampler = tsm.make_sampler(var.cfg, vae.cfg, top_k=1, dtype=torch.float32, device="cpu")
    for _ in range(2):
        sampler(var.eval(), vae, torch.Generator().manual_seed(0), [1, 2])
    n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in vae.decoder.modules())
    assert profiling.counters() == {**{k: 0 for k in profiling.COUNTERS}, "compiled.calls": 5,
                                    "vae.gn_plain": 2 * n_gn}


def test_a_call_counts_its_host_time_when_it_replayed():
    profiling.reset()
    with profiling.call("sampler.call", "sampler.calls", "sampler.host_s"):
        pass
    assert profiling.counters()["sampler.calls"] == 0
    with profiling.call("sampler.call", "sampler.calls", "sampler.host_s"):
        profiling.replayed(None, CPU)
        time.sleep(0.01)
    c = profiling.counters()
    assert (c["compiled.replays"], c["sampler.calls"]) == (1, 1)
    assert 0.01 <= c["sampler.host_s"] < 1.0
    profiling.reset()


NEW_READERS = ("transformer_ms.sample", "head_ms.sample", "filter_ms.sample",
               "next_input_ms.sample", "render_ms.sample", "host_ms.sample",
               "tokenize_ms.train", "forward_ms.train", "backward_ms.train",
               "optimizer_ms.train", "allreduce_ms.train", "host_ms.train", "captures")


def _view(batch):
    return SimpleNamespace(traffic={"batch": batch}, trace=None, capture_s=None,
                           peak_bytes=None)


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_finds_nothing_in_an_empty_store(name):
    profiling.reset()
    assert Registry(ROOT).reader(name)(_view(4)) is None


def _synthetic_spans():
    """Two replays of a sampler (calls 0 and 1, 3 stages: each span 1 ms,
    the render 2 ms) and three steps with an all-reduce of 5 ms."""
    out, ms = [], 1_000_000
    for call in (0, 1):
        t = 0
        for name in ["start"] + ["transformer", "head", "filter", "next_input"] * 3:
            out.append(Span(name, "sample", call, 0, t, t + ms))
            t += ms
        out.append(Span("render", "sample", call, 0, t, t + 2 * ms))
    for call in (2, 3, 4):
        for i, name in enumerate(("tokenize", "forward", "backward", "allreduce",
                                  "optimizer")):
            out.append(Span(name, "train_step", call, 0, 10 * i * ms, (10 * i + 5) * ms))
    return out


@pytest.mark.parametrize("name,batch,want", [
    ("transformer_ms.sample", 4, 3 / 4), ("head_ms.sample", 4, 3 / 4),
    ("filter_ms.sample", 2, 3 / 2), ("next_input_ms.sample", 4, 3 / 4),
    ("render_ms.sample", 4, 2 / 4), ("tokenize_ms.train", 32, 5 / 32),
    ("forward_ms.train", 32, 5 / 32), ("backward_ms.train", 32, 5 / 32),
    ("optimizer_ms.train", 32, 5 / 32), ("allreduce_ms.train", 32, 5.0),
    ("host_ms.sample", 4, 1e3 * 0.5 / 8), ("host_ms.train", 32, 1e3 * 0.9 / 3),
    ("captures", 4, 2)])
def test_a_reader_of_a_synthetic_store(monkeypatch, name, batch, want):
    monkeypatch.setattr(profiling, "spans", _synthetic_spans)
    for key, v in {"sampler.host_s": 0.5, "sampler.calls": 8, "train.host_s": 0.9,
                   "train.steps": 3, "compiled.captures": 2}.items():
        monkeypatch.setitem(profiling.COUNTERS, key, v)
    assert Registry(ROOT).reader(name)(_view(batch)) == pytest.approx(want)
