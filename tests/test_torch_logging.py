"""The port's logging and tracing (``var_tpu_torch/utils/logging.py``)
against the JAX package's ``var_tpu/utils/logging.py``, on the CPU: the same
meter numbers and strings, the same ``log.txt``, the same npz."""

import glob
import os
import re
import sys

import numpy as np
import pytest

from var_tpu.config import TrainArgs as JaxTrainArgs
from var_tpu.utils import logging as jlog
from var_tpu_torch.config import TrainArgs
from var_tpu_torch.utils import logging as tlog


def _feed(mod, values):
    me = mod.MetricLogger()
    for i, v in enumerate(values):
        me.update(Lm=v, tlr=1e-4 * (i + 1), step_t=0.25 + 0.01 * (i % 7), skipped=None)
    return me


def test_meters_match_jax():
    """Medians over the 30-wide window, averages, global averages, the last
    value, the formatted line and the time left, on 45 seeded values."""
    values = np.random.default_rng(0).standard_normal(45).tolist()
    t, j = _feed(tlog, values), _feed(jlog, values)
    assert str(t) == str(j)
    assert list(t.meters) == ["Lm", "tlr", "step_t"]
    for name in t.meters:
        a, b = t.meters[name], j.meters[name]
        assert (a.median, a.avg, a.global_avg, a.value, a.count) == \
            (b.median, b.avg, b.global_avg, b.value, b.count)
        assert a.eta(123)[0] == b.eta(123)[0]
    assert re.fullmatch(r"ETA 0:00:\d\d \(\d{4}-\d\d-\d\d \d\d:\d\d\)", t.eta("step_t", 100))
    assert t.eta("absent", 3) == j.eta("absent", 3) == "?"
    fmt = "{value:.3f} max {max:.3f}"
    a, b = tlog.SmoothedValue(5, fmt), jlog.SmoothedValue(5, fmt)
    for v in values[:9]:
        a.update(v, n=2)
        b.update(v, n=2)
    assert str(a) == str(b) and a.global_avg == b.global_avg


def test_dump_log_line_writes_jax_log_txt(tmp_path):
    stats = [dict(ep="1/2", L_mean=8.3125, acc_mean=0.0, lr=2.2e-06, ep_time=2.1),
             dict(ep="2/2", L_mean=8.25, acc_mean=1.5, lr=3.1e-08, ep_time=2.0)]
    texts = []
    for mod, args_cls in ((tlog, TrainArgs), (jlog, JaxTrainArgs)):
        args = args_cls(local_out_dir_path=str(tmp_path / "out"), exp_name="d2").finalize()
        args.tb_log_dir_path = "tb"  # the two packages name their run folders alike
        os.makedirs(args.local_out_dir_path, exist_ok=True)
        for i, s in enumerate(stats):
            mod.dump_log_line(args, _first=(i == 0), **s)
        with open(args.log_txt_path) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    assert texts[0].splitlines()[0] == '{"name": "d2", "cmd": "", "tb_log_dir_path": "tb"}'
    assert len(texts[0].splitlines()) == 3


def test_create_npz_from_sample_folder_matches_jax(tmp_path):
    from PIL import Image

    folder = tmp_path / "samples"
    folder.mkdir()
    rng = np.random.default_rng(1)
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            folder / f"{i:06d}.png")
    path = tlog.create_npz_from_sample_folder(str(folder), num=5)
    got = np.load(path)["arr_0"]
    want = np.load(jlog.create_npz_from_sample_folder(str(folder), num=5))["arr_0"]
    assert path == f"{folder}.npz" and got.shape == (5, 16, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_log_format_and_tee(tmp_path, capsys):
    assert tlog.is_master()
    for mod in (tlog, jlog):  # one call site: the same file:line prefix
        mod.log("hello", 3)
    got, want = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"\[\d\d-\d\d \d\d:\d\d:\d\d\] \( *test_torch_logging\.py:\d+\) => "
                        r"hello 3", got)
    assert got[16:] == want[16:]  # all but the timestamp
    out, err = sys.stdout, sys.stderr
    restore = tlog.tee_output(str(tmp_path / "run"))
    try:
        print("to both")
        print("err line", file=sys.stderr)
    finally:
        restore()
    assert sys.stdout is out and sys.stderr is err
    assert (tmp_path / "run" / "stdout.txt").read_text() == "to both\n"
    assert (tmp_path / "run" / "stderr.txt").read_text() == "err line\n"
    assert "to both" in capsys.readouterr().out


def test_tensorboard_logger_writes_scalars_or_noops(tmp_path, monkeypatch):
    pytest.importorskip("tensorboardX")
    tb = tlog.TensorboardLogger(str(tmp_path / "tb"))
    tb.set_step(4)
    tb.update(head="AR_iter_loss", Lm=1.5, skipped=None)
    tb.update(head="AR_ep_loss", step=1, vL_mean=2.5)
    tb.close()
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # not installed
    off = tlog.TensorboardLogger(str(tmp_path / "tb_off"))
    assert not off.enabled and off.writer is None
    off.update(head="x", y=1.0)
    off.close()
    assert not (tmp_path / "tb_off").exists()


def test_profiler_hooks_trace_a_step_window(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("VAR_TPU_PROFILE_DIR", raising=False)
    idle = tlog.ProfilerHooks(start_step=0, num_steps=1)
    for step in range(3):
        idle.maybe_toggle(step)
    monkeypatch.setenv("VAR_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    hooks = tlog.ProfilerHooks(start_step=1, num_steps=2)
    x = torch.ones(64, 64)
    for step in range(5):
        hooks.maybe_toggle(step)
        x = x @ x / 64
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1 and hooks._prof is None
    with open(traces[0]) as f:
        assert "aten::mm" in f.read()
