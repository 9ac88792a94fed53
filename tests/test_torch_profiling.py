"""The port's tracing (``utils/profiling.py``) on the CPU: the stamp layout
a capture records and the spans rebuilt from a ring, host ranges only under
a profiler, the layers the sampler and the training step mark, the
counters, and the benchmark's readers of them. A captured program's stamps
run only on the card (``tests/test_torch_cuda.py``)."""

import collections
import contextlib
import copy
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import profile
from torch.utils._python_dispatch import TorchDispatchMode

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
    """Recorded as a capture records them: the decode's layers tile it (each
    starts where the one before it ended), four stamps a stage and four
    more, and two more for each block's ``attention`` span inside
    ``transformer``; the step's five layers take seven."""
    layout, launched = _recorded(lambda: _tiny_sample(models), "sample")
    stages, depth = len(SPEC["var"]["patch_nums"]), models[1].cfg.depth
    layers = [s for s in layout.spans if s[0] != "attention"]
    assert [s[0] for s in layers] == ["sample", "start", *["transformer", "head", "filter",
                                                           "next_input"] * stages, "render"]
    assert launched == layout.n == 4 * stages + 4 + 2 * depth * stages
    assert all(cur[2] == prev[3] for prev, cur in zip(layers[1:], layers[2:]))
    assert all(s[1] == 0 for s in layers[1:])
    vae, _ = models
    step, state, (imgs, labels) = _tiny_step(models)
    hyper = torch.tensor([1e-4, 0.05, 1.0])
    layout, launched = _recorded(lambda: step.program.eager(
        state, vae, imgs, labels, hyper, generator=torch.Generator().manual_seed(0)),
        "train_step")
    assert [s[0] for s in layout.spans] == ["train_step", *TRAIN_SPANS]
    assert launched == layout.n == 7


def test_attention_spans_stand_on_stamps_of_their_own(models):
    """Each block of each stage puts one ``attention`` span under that
    stage's ``transformer``, on a start and an end stamp that no other span
    uses; ``transformer`` starts on the stamp its predecessor ended on and
    ends on a stamp of its own after the last block."""
    layout, _ = _recorded(lambda: _tiny_sample(models), "sample")
    stages, depth = len(SPEC["var"]["patch_nums"]), models[1].cfg.depth
    spans = layout.spans
    attn = [i for i, s in enumerate(spans) if s[0] == "attention"]
    assert len(attn) == depth * stages
    for i in attn:
        name, parent, a, b = spans[i]
        assert spans[parent][0] == "transformer" and a < b
        p_start, p_end = spans[parent][2:]
        assert p_start < a and b < p_end
        others = [st for j, sp in enumerate(spans) if j != i for st in sp[2:]]
        assert a not in others and b not in others
    per_stage = collections.Counter(spans[i][1] for i in attn)
    assert sorted(per_stage.values()) == [depth] * stages


class _OpLog(TorchDispatchMode):
    """Appends each dispatched operation's name to ``log``."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.log.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops_by_span(models, attention_spans: bool, monkeypatch):
    """[(name, the operations between its stamps)] of a decode recorded
    with a fake launch that logs its stamps among the operations."""
    from var_tpu_torch.models import var as var_mod

    real = var_mod.span
    if not attention_spans:  # the layout the decode had before the attention spans
        monkeypatch.setattr(var_mod, "span", lambda name, *a, **k: contextlib.nullcontext()
                            if name == "attention" else real(name, *a, **k))
    log = []
    with _OpLog(log), Recording(CPU, "sample", launch=lambda: log.append(None)) as layout:
        _tiny_sample(models)
    monkeypatch.setattr(var_mod, "span", real)
    marks = [i for i, op in enumerate(log) if op is None]
    assert len(marks) == layout.n
    return [(name, [op for op in log[marks[a] + 1:marks[b]] if op is not None])
            for name, _, a, b in layout.spans]


def test_the_attention_spans_leave_every_layer_its_operations(models, monkeypatch):
    """Every span the decode had before the attention spans bounds the same
    operations, in order, with them as without them; an ``attention`` span
    bounds the cached attention alone: its softmax, none of the QKV,
    projection or FFN products (``linear``), the k norm's write into the
    cache (``mul.out``), the V write (``copy_``) or the GELU."""
    without = _ops_by_span(models, False, monkeypatch)
    with_attn = _ops_by_span(models, True, monkeypatch)
    assert "attention" not in {n for n, _ in without}
    assert [(n, ops) for n, ops in with_attn if n != "attention"] == without
    for name, ops in with_attn:
        if name == "attention":
            assert any("softmax" in op for op in ops), ops
            assert not any(w in op for op in ops for w in ("linear", "mul.out", "copy_",
                                                           "gelu")), ops


def test_sampler_kv_bytes_counts_the_decode_cache(models):
    """``sampler.kv_bytes``: the K and V buffers of a decode's cache, (depth,
    2B, L, C) each, here float32; a smaller decode after it leaves it."""
    vae, var = models
    cfg = var.cfg
    profiling.reset()
    _tiny_sample(models)  # batch 2: the CFG batch is 4
    want = 2 * cfg.depth * 4 * cfg.seq_len * cfg.embed_dim * 4
    assert profiling.counters()["sampler.kv_bytes"] == want
    with torch.inference_mode():
        tsm.decode_cfg(var.eval(), vae, torch.tensor([1]), torch.Generator().manual_seed(0),
                       top_k=1, dtype=torch.float32)
    assert profiling.counters()["sampler.kv_bytes"] == want
    profiling.reset()


def test_counters_of_programs_on_the_cpu(models, monkeypatch):
    """On the CPU a compiled program runs its body eagerly: its calls
    count, and no capture or replay does; a sampler call that replayed
    nothing adds no host time; each call's float32 render runs its
    decoder's GroupNorms on the plain path, and its decode each block's
    cache write of each stage through the plain version."""
    from var_tpu_torch.models import vae as tv
    from var_tpu_torch.ops.cuda import kv_write as kw

    calls = collections.Counter()

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, name, call)

    spy(tv, "group_norm")
    spy(kw, "kv_write_plain")
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
    kv = 2 * var.cfg.depth * 4 * var.cfg.seq_len * var.cfg.embed_dim * 4  # float32, CFG batch 4
    writes = 2 * var.cfg.depth * len(var.cfg.patch_nums)
    assert profiling.counters() == {**{k: 0 for k in profiling.COUNTERS}, "compiled.calls": 5,
                                    "sampler.kv_bytes": kv}
    assert calls == {"group_norm": 2 * n_gn, "kv_write_plain": writes}


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
               "optimizer_ms.train", "allreduce_ms.train", "host_ms.train", "captures",
               "attention_ms.sample", "attention_roofline.sample", "kv_cache_gb.sample")


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


def _attention_spans(per_call: int, calls=(0, 1), ms: float = 0.1):
    """``per_call`` attention spans of ``ms`` each in each replay of
    ``calls``, under its stages' ``transformer``."""
    ns = int(ms * 1e6)
    return [Span("attention", "transformer", call, 0, i * 2 * ns, i * 2 * ns + ns)
            for call in calls for i in range(per_call)]


def test_the_attention_readers_of_a_synthetic_store(monkeypatch):
    """``attention_ms.sample``: the spans' ms over the replays and the
    batch; ``attention_roofline.sample``: row 2's bound of a call
    (``benchmark/counts/kernels.py``, unchanged) times the replays over the
    spans' seconds, None when a replay holds another number of spans than a
    call launches; ``kv_cache_gb.sample``: the counter in GB."""
    from benchmark.counts.kernels import sample_rows
    from benchmark.reference.models import Sizes

    reg = Registry(ROOT)
    sizes = Sizes.from_config(json.loads((ROOT / "benchmark/configs/var-d36-512.json")
                                         .read_text()))
    view = SimpleNamespace(traffic={"batch": 16}, sizes=sizes, trace=None, capture_s=None,
                           peak_bytes=None)
    n, bound = sample_rows(sizes, 16)["row2"]
    assert n == 36 * 10
    monkeypatch.setattr(profiling, "spans", lambda: _attention_spans(n))
    assert reg.reader("attention_ms.sample")(view) == pytest.approx(n * 0.1 / 16)
    assert reg.reader("attention_roofline.sample")(view) == pytest.approx(
        100 * bound * 2 / (2 * n * 1e-4))
    monkeypatch.setattr(profiling, "spans", lambda: _attention_spans(n - 1))
    assert reg.reader("attention_roofline.sample")(view) is None
    monkeypatch.setitem(profiling.COUNTERS, "sampler.kv_bytes", 16 * 1_486_356_480)
    assert reg.reader("kv_cache_gb.sample")(view) == pytest.approx(23.7817, abs=1e-4)
