"""The last line: its keys, its metrics by trace mode, ``checks`` last."""

import json

import pytest

import benchmark.run as R
from benchmark.harness import trace as T
from benchmark.harness.registry import Registry
from benchmark.tests.conftest import ROOT, cpu_context


def out_of_a_run(tr=None):
    return {"attempted": 12, "failed": 0, "peak_bytes": 9e9, "capture_s": 3.0, "trace": tr,
            "e2e": {"sample_img_per_s": 200.5, "sample_p95_ms": 150.0,
                    "train_img_per_s": None, "setup_s": 21.0}}


def line_of(cell_name, trace):
    reg = Registry(ROOT)
    cell = reg.cell(cell_name)
    ctx = cpu_context(reg.config(cell["config"]), reg.traffic(cell["traffic"]))
    tr = None
    if trace:
        tr = T.read([{"ph": "X", "cat": "user_annotation", "name": T.WINDOW, "ts": 0,
                      "dur": 100}, {"ph": "X", "cat": "kernel", "name": "nvjet", "ts": 1,
                                    "dur": 50}])
        tr.calls, tr.images = 1, 8
    out = out_of_a_run(tr)
    ok, checks = R.judge({"greedy_gap": 0.1, "filter_share": 0.0, "image_err": 0.5},
                         reg.limits(cell_name))
    args = type("Args", (), {"trace": trace})
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 9e9}
    return json.loads(json.dumps(R.result_line(reg, cell, out, ok, checks, args, device,
                                               R.RunView(ctx, cell, out))))


@pytest.mark.parametrize("trace", [0, 1])
def test_keys_and_checks_last(trace):
    line = line_of("d30-demo8", trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["checks"]) == {"greedy_gap", "filter_share", "image_err"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "sample_img_per_s" not in line["metrics"] and "gemm_ms.sample" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"sample_img_per_s", "sample_p95_ms", "setup_s"}


def test_a_cell_reports_only_its_own_end_to_end_metrics():
    assert set(line_of("d16-fid50", 0)["metrics"]) == {"sample_img_per_s", "setup_s"}


def test_judge_needs_every_number_under_its_limit():
    assert R.judge({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 3.0})[0]
    assert not R.judge({"a": 1.5, "b": 2.0}, {"a": 1.0, "b": 3.0})[0]
    assert not R.judge({"a": 1.0}, {"a": 1.0, "b": 3.0})[0]


def test_the_percentile_counts_failures_as_missing():
    from benchmark.harness.sample import p95

    assert p95(list(range(1, 101)), 0) == 95
    assert p95(list(range(1, 21)), 1) == 20  # nearest rank 20 of 21
    assert p95(list(range(1, 21)), 2) == float("inf")
