"""Everything of one configuration, traffic mix, cell or per-layer metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the entry's ``file``): the sizes;
* ``traffic/<traffic>.json``: the mix, whose ``kind`` names the generator
  ``harness/<kind>.py`` that reads it;
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``metrics/<name>.py``: the reader of one per-layer metric, a function
  ``read(run)`` that returns a number, or None when it finds nothing.

A later change adds files and entries; it edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark's directory


class Registry:
    def __init__(self, root: Path):
        """``root``: the checkout, holding ``BENCHMARK.json``."""
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.bench["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def generator(self, kind: str):
        return importlib.import_module(f"benchmark.harness.{kind}")

    def metrics(self, cell: str, group: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` that ``cell``
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.bench[group] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
