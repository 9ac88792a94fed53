"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and entries only are found by name; no file of the harness changes."""

import json
import shutil

from benchmark.harness.registry import Registry
from benchmark.tests.conftest import ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "var-d16.json").read_text())
    cfg.update(depth=20, embed_dim=1280, num_heads=20)
    (b / "configs" / "var-d20.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "fid50.json").read_text())
    mix.update(batch=25)
    (b / "traffic" / "fid25.json").write_text(json.dumps(mix))
    (b / "limits" / "d20-fid25.json").write_text(json.dumps({"greedy_gap": 1.0}))
    (b / "metrics" / "launches.sample.py").write_text(
        "def read(run):\n    return 42.0 if run.trace is None else None\n")
    bench["configs"].append({"name": "var-d20", "source": "https://arxiv.org/abs/2404.02905",
                             "file": "benchmark/configs/var-d20.json", "reduced": [],
                             "why": "d20"})
    bench["workloads"].append({"name": "d20-fid25", "config": "var-d20", "traffic": "fid25",
                               "chips": 1, "why": "d20 at batch 25"})
    bench["per_layer"].append({"name": "launches.sample", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "kernels (ops/cuda)",
                               "moves": "sample_img_per_s", "workloads": ["d20-fid25"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(tmp_path)
    cell = reg.cell("d20-fid25")
    assert reg.config(cell["config"])["depth"] == 20
    assert reg.traffic(cell["traffic"])["batch"] == 25
    assert reg.limits("d20-fid25") == {"greedy_gap": 1.0}
    assert reg.generator(reg.traffic(cell["traffic"])["kind"]).__name__.endswith("sample")
    names = [m["name"] for m in reg.metrics("d20-fid25", "per_layer")]
    assert names == ["launches.sample"]
    assert reg.reader("launches.sample")(type("V", (), {"trace": None})) == 42.0
    assert "launches.sample" not in [m["name"] for m in reg.metrics("d16-fid50", "per_layer")]
    for rel, data in before.items():  # every file the harness had is as it was
        assert (tmp_path / rel).read_bytes() == data
