"""End to end, the port's ImageNet-folder training CLI on the CPU
(``python -m var_tpu_torch.apps.train --device cpu``): a two-epoch run on a
folder of seeded PNGs trains, evaluates, checkpoints and writes ``log.txt``;
a run killed (SIGKILL) after its first mid-epoch checkpoint and started
again resumes to final parameters and optimizer state equal bit for bit to
the uninterrupted run's (``tests/test_resume.py`` is the JAX package's
counterpart)."""

import ast
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _make_dataset(root):
    """2 classes x 8 train and 2 val images, 48 x 48, seeded."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 2)):
        for c in range(2):
            d = os.path.join(root, split, f"class_{c}")
            os.makedirs(d)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(
                    os.path.join(d, f"img_{i}.png"))


def _flags(data, out, ckpt_iters=0):
    # random crops (mid_reso 1.125) and flips on: the (seed, epoch, index)
    # streams make them restart-invariant
    return [f"--data_path={data}", "--depth=2", "--bs=8", "--ep=2", "--hflip=1",
            "--allow_random_vae=1", "--pn=1_2_3", "--seed=1", "--workers=2", "--device", "cpu",
            f"--local_out_dir_path={out}", f"--ckpt_iters={ckpt_iters}"]


def _popen(flags, env):
    return subprocess.Popen([sys.executable, "-m", "var_tpu_torch.apps.train", *flags],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A uninterrupted; run B (mid-epoch checkpoints every step) killed
    once its first mid-epoch checkpoint is on disk, then started again."""
    tmp = tmp_path_factory.mktemp("cli")
    data = str(tmp / "data")
    _make_dataset(data)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT,
               VAR_TPU_VAE_CKPT=str(tmp / "absent.pth"))
    out_a, out_b = str(tmp / "outA"), str(tmp / "outB")
    run_a = _popen(_flags(data, out_a), env)
    run_b = _popen(_flags(data, out_b, ckpt_iters=1), env)
    meta_path = os.path.join(out_b, "ar-ckpt-last.pth.meta.json")
    killed_at = None
    deadline = time.time() + TIMEOUT
    while killed_at is None and run_b.poll() is None and time.time() < deadline:
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            meta = {}
        if int(meta.get("iter", 0)) > 0:  # a true mid-epoch checkpoint
            run_b.send_signal(signal.SIGKILL)
            killed_at = (meta["epoch"], meta["iter"])
        time.sleep(0.02)
    log_b = run_b.communicate(timeout=TIMEOUT)[0]
    assert killed_at is not None and run_b.returncode == -signal.SIGKILL, log_b[-3000:]
    resumed = _popen(_flags(data, out_b, ckpt_iters=1), env)  # while run A goes on
    log_a = run_a.communicate(timeout=TIMEOUT)[0]
    log_resumed = resumed.communicate(timeout=TIMEOUT)[0]
    assert run_a.returncode == 0, log_a[-3000:]
    assert resumed.returncode == 0, log_resumed[-3000:]
    return dict(out_a=out_a, out_b=out_b, log_a=log_a, log_resumed=log_resumed,
                killed_at=killed_at)


def test_cli_without_tokenizer_checkpoint_exits(tmp_path, monkeypatch):
    from var_tpu_torch.apps.train import main

    monkeypatch.setenv("VAR_TPU_VAE_CKPT", str(tmp_path / "absent.pth"))
    out, err = sys.stdout, sys.stderr
    with pytest.raises(SystemExit, match="absent.pth' not found.*--allow_random_vae=1"):
        main(["--device", "cpu", "--depth=2", "--pn=1_2_3", f"--data_path={tmp_path}",
              f"--local_out_dir_path={tmp_path / 'out'}"])
    assert sys.stdout is out and sys.stderr is err  # the tee is undone
    assert (tmp_path / "out" / "stdout.txt").exists()


def test_cli_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from var_tpu_torch.apps.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main([f"--data_path={tmp_path}", f"--local_out_dir_path={tmp_path / 'out'}"])


def test_cli_trains_evaluates_and_checkpoints(runs):
    log = runs["log_a"]
    assert "RANDOM tokenizer" in log and "VAR params: " in log
    assert "dataset: 16 train, 4 val images" in log
    assert log.count("=> [ep 0/2] [") == 2 and log.count("=> [ep 1/2] [") == 2
    assert "[ep 1] val: L_mean " in log and "(n=4)" in log
    assert "[ep 0] val" not in log  # val_freq_ep 10: only the last epoch
    assert "mid-epoch checkpoint" not in log and "training done" in log
    out = runs["out_a"]
    for name in ("ar-ckpt-last.pth", "ar-ckpt-last.pth-best"):
        with open(os.path.join(out, name + ".meta.json")) as f:
            meta = json.load(f)
        assert meta["epoch"] == 2 and meta["iter"] == 0 and meta["best_val_lt"] < 1e9
    best = torch.load(os.path.join(out, "ar-ckpt-last.pth-best"), weights_only=True)
    last = torch.load(os.path.join(out, "ar-ckpt-last.pth"), weights_only=True)
    assert best["step"] == last["step"] == 4
    assert all(torch.equal(last["var"][k], v) for k, v in best["var"].items())
    with open(os.path.join(out, "stdout.txt")) as f:  # teed
        teed = f.read()
    assert "VAR params: " in teed and "[ep 1] val: L_mean " in teed and "training done" in teed


def test_cli_log_txt_lines(runs):
    with open(os.path.join(runs["out_a"], "log.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 3
    head = json.loads(lines[0])
    assert head["name"] == "text" and head["tb_log_dir_path"].startswith(runs["out_a"])
    for i, line in enumerate(lines[1:]):
        stats = ast.literal_eval(line)  # the reference's dict-repr line
        assert list(stats) == ["ep", "L_mean", "acc_mean", "lr", "ep_time"]
        assert stats["ep"] == f"{i + 1}/2" and np.isfinite(stats["L_mean"])


def test_cli_killed_and_resumed_run_equals_uninterrupted(runs):
    assert runs["killed_at"] == (0, 1)
    assert "auto-resuming from " in runs["log_resumed"]
    assert "at ep0 it1" in runs["log_resumed"]
    a = torch.load(os.path.join(runs["out_a"], "ar-ckpt-last.pth"), weights_only=True)
    b = torch.load(os.path.join(runs["out_b"], "ar-ckpt-last.pth"), weights_only=True)
    assert a["step"] == b["step"] == 4
    assert list(a["var"]) == list(b["var"])
    for k, v in a["var"].items():
        assert torch.equal(v, b["var"][k]), f"parameter {k} diverged"
    for pa, pb in zip(a["opt"]["state"].values(), b["opt"]["state"].values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), f"optimizer state {k} diverged"
