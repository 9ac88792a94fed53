"""Logging, metrics and tracing (counterpart of ``var_tpu/utils/logging.py``;
reference ``utils/misc.py:54-381``, ``utils/arg_util.py:177-196``), with the
same strings and scalar names:

* ``log``: timestamped, source-located, printed on the master rank only
  (rank 0 of ``torch.distributed`` when it is initialised);
* ``tee_output``: stdout and stderr copied to files in the output folder;
* ``SmoothedValue`` / ``MetricLogger``: windowed meters with an ETA;
* ``TensorboardLogger``: tensorboardX scalars when the package imports, a
  no-op otherwise;
* ``dump_log_line``: one dict line per epoch in ``log.txt``;
* ``create_npz_from_sample_folder``: PNG samples packed for the FID
  protocol;
* ``ProfilerHooks``: a ``torch.profiler`` window over steps
  ``[start, start + num)`` when ``VAR_TPU_PROFILE_DIR`` is set.

Pillow, tensorboardX and the profiler are imported inside the functions
that use them.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np


def is_master() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def log(*args, force: bool = False):
    """Timestamp + file:line prefixed print, master-only unless ``force``."""
    if not (is_master() or force):
        return
    caller = sys._getframe(1)
    src = f"{os.path.basename(caller.f_code.co_filename)}:{caller.f_lineno}"
    ts = datetime.datetime.now().strftime("%m-%d %H:%M:%S")
    print(f"[{ts}] ({src:>20s}) =>", *args, flush=True)


class _Tee:
    def __init__(self, stream, path):
        self.stream = stream
        self.f = open(path, "a", buffering=1)

    def write(self, s):
        self.stream.write(s)
        self.f.write(s)

    def flush(self):
        self.stream.flush()
        self.f.flush()

    def isatty(self):
        return False


def tee_output(out_dir: str) -> Callable[[], None]:
    """Tee stdout/stderr to ``{out_dir}/stdout.txt`` / ``stderr.txt``
    (reference ``SyncPrint``, misc.py:78-112): line-buffered, append mode so
    restarted runs keep one continuous log. Returns a function that puts the
    streams back and closes the files."""
    os.makedirs(out_dir, exist_ok=True)
    out, err = sys.stdout, sys.stderr
    sys.stdout = tee_out = _Tee(out, os.path.join(out_dir, "stdout.txt"))
    sys.stderr = tee_err = _Tee(err, os.path.join(out_dir, "stderr.txt"))

    def restore() -> None:
        sys.stdout, sys.stderr = out, err
        tee_out.f.close()
        tee_err.f.close()

    return restore


class SmoothedValue:
    """Windowed median/avg meter (reference ``misc.py:183-249``)."""

    def __init__(self, window_size: int = 30, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def eta(self, n_remaining: int) -> Tuple[str, str]:
        """("H:MM:SS left", "finishes at YYYY-mm-dd HH:MM") from the windowed
        median per-item time."""
        secs = self.median * n_remaining
        left = str(datetime.timedelta(seconds=int(round(secs))))
        done_at = datetime.datetime.now() + datetime.timedelta(seconds=secs)
        return left, done_at.strftime("%Y-%m-%d %H:%M")

    def __str__(self):
        stats = dict(median=self.median, avg=self.avg, global_avg=self.global_avg,
                     value=self.value, max=max(self.deque, default=0.0))
        return self.fmt.format(**stats)


class MetricLogger:
    """Iteration logger with meters + ETA (reference ``misc.py:252-337``)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict = {}
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters.setdefault(k, SmoothedValue()).update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def eta(self, meter: str, n_remaining: int) -> str:
        """ETA string from the named per-step-seconds meter (misc.py:303-307)."""
        if meter not in self.meters:
            return "?"
        left, finish = self.meters[meter].eta(n_remaining)
        return f"ETA {left} ({finish})"


class TensorboardLogger:
    """tensorboardX scalar logger; a no-op when the package or the master
    role is absent (reference DistLogger + TensorboardLogger,
    ``misc.py:115-180``)."""

    def __init__(self, log_dir: str, enabled: Optional[bool] = None):
        self.enabled = is_master() if enabled is None else enabled
        self.writer = None
        self.step = 0
        if self.enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                self.enabled = False
            else:
                os.makedirs(log_dir, exist_ok=True)
                self.writer = SummaryWriter(log_dir)

    def set_step(self, step: Optional[int] = None):
        if step is not None:
            self.step = step

    def update(self, head: str = "scalar", step: Optional[int] = None, **kwargs):
        if not self.writer:
            return
        s = self.step if step is None else step
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(f"{head}/{k}", float(v), s)

    def log_tensor_as_distri(self, tag: str, tensor, step: Optional[int] = None):
        """Histogram of a tensor's values (reference ``misc.py:155-165``)."""
        if not self.writer:
            return
        values = np.asarray(tensor.detach().float().cpu() if hasattr(tensor, "detach")
                            else tensor, np.float32).ravel()
        self.writer.add_histogram(tag, values, self.step if step is None else step)

    def log_image(self, tag: str, img_chw, step: Optional[int] = None):
        """CHW image in [0, 1] (reference ``misc.py:167-174``)."""
        if not self.writer:
            return
        img = img_chw.detach().float().cpu() if hasattr(img_chw, "detach") else img_chw
        self.writer.add_image(tag, np.asarray(img), self.step if step is None else step)

    def flush(self):
        if self.writer:
            self.writer.flush()

    def close(self):
        if self.writer:
            self.writer.close()


def dump_log_line(args, **stats):
    """Append one dict-repr line per epoch to log.txt (arg_util.py:177-196)."""
    if not is_master():
        return
    first = stats.pop("_first", False)
    if first:
        with open(args.log_txt_path, "w") as f:
            json.dump({"name": args.exp_name, "cmd": "",
                       "tb_log_dir_path": args.tb_log_dir_path}, f)
            f.write("\n")
    with open(args.log_txt_path, "a") as f:
        f.write(f"{stats}\n")


def create_npz_from_sample_folder(sample_dir: str, num: int = 50_000) -> str:
    """Pack PNG samples into the OpenAI-evaluator npz (``misc.py:360-381``)."""
    from PIL import Image

    samples = []
    for i in range(num):
        img = np.asarray(Image.open(os.path.join(sample_dir, f"{i:06d}.png")))
        assert img.shape == (img.shape[0], img.shape[0], 3)
        samples.append(img)
    arr = np.stack(samples)
    npz_path = f"{sample_dir}.npz"
    np.savez(npz_path, arr_0=arr)
    print(f"Saved .npz file to {npz_path} [shape={arr.shape}]")
    return npz_path


class ProfilerHooks:
    """``torch.profiler`` window over steps ``[start_step, start_step +
    num_steps)``: enable with ``VAR_TPU_PROFILE_DIR=<dir>``; the trace is
    written there in the tensorboard profile plugin's format (one
    ``*.pt.trace.json``), with CUDA activity when a GPU is present."""

    def __init__(self, out_dir: Optional[str] = None, start_step: int = 10, num_steps: int = 5):
        self.out_dir = out_dir or os.environ.get("VAR_TPU_PROFILE_DIR")
        self.start, self.stop = start_step, start_step + num_steps
        self._prof = None

    def maybe_toggle(self, step: int):
        if not self.out_dir:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        if step == self.start and self._prof is None:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts,
                                 on_trace_ready=tensorboard_trace_handler(self.out_dir))
            self._prof.__enter__()
        elif step >= self.stop and self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._prof = None
