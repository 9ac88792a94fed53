"""``BENCHMARK.json`` against the rules a benchmark file keeps: names,
units, lengths, every cell reporting ``setup_s``, another end-to-end
metric and a per-layer one, every per-layer metric's cells reporting the
metric it moves, every file where the registry looks for it."""

import json
import re

from benchmark.harness.registry import Registry
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def short(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_file_keeps_the_rules():
    b = bench()
    assert set(b) == KEYS and (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert all(short(w) for w in b["command"]) and len(b["command"]) <= 32
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[g]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert short(c["why"]) and short(c["source"]) and c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and short(m["layer"])


def test_every_cell_reports_what_it_must():
    b, reg = bench(), Registry(ROOT)
    for w in b["workloads"]:
        assert short(w["why"]) and w["chips"] in (1, 4)
        e2e = {m["name"] for m in reg.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = reg.metrics(w["name"], "per_layer")
        assert layer
        for m in layer:  # a per-layer metric's cells report the metric it moves
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert (reg.dir / "metrics" / f"{m['name']}.py").is_file()
        assert reg.traffic(w["traffic"])["kind"] in ("sample", "train")
        assert set(reg.limits(w["name"]))
