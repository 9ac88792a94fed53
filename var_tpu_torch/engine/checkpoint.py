"""Checkpoint save / auto-resume (counterpart of ``var_tpu/engine/checkpoint.py``).

A checkpoint is one ``torch.save`` file of the training state -- the VAR
state dict, the optimizer's, the step count and the dynamic loss-scale
state -- with a ``.meta.json`` sidecar (epoch, iteration, args), as the
reference's ``ar-ckpt-last.pth`` flow (``train.py:218-231``). Saving writes
a temporary file and swaps it in, so a crash never leaves a torn
checkpoint. ``auto_resume`` picks the newest ``ar-ckpt*`` file.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Tuple

import torch

TMP_SUFFIX = ".tmp_new"


def save_checkpoint(path: str, state, meta: Optional[dict] = None) -> None:
    """Write ``state`` (an ``engine.trainer.TrainState``) to ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + TMP_SUFFIX
    torch.save({"var": state.var.state_dict(), "opt": state.opt.opt.state_dict(),
                "step": state.step, "scaler": state.scaler}, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, default=str)


def load_checkpoint(path: str, state):
    """Restore ``path`` into ``state`` in place (its modules keep their
    device) and return it. The optimizer's load makes new moment tensors,
    so a compiled step captures again on its next call; the loss-scale
    state is copied into the state's own device scalars."""
    ckpt = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    state.var.load_state_dict(ckpt["var"])
    state.opt.opt.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
    if state.scaler is not None and ckpt["scaler"] is not None:
        for k, t in state.scaler.items():
            t.copy_(torch.as_tensor(ckpt["scaler"][k]))
    return state


def load_meta(path: str) -> dict:
    p = path + ".meta.json"
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def auto_resume(out_dir: str, pattern: str = "ar-ckpt*") -> Tuple[Optional[str], dict]:
    """Newest matching checkpoint file (or None) and its meta
    (reference ``misc.glob_with_latest_modified_first`` + ``auto_resume``)."""
    cands = [p for p in glob.glob(os.path.join(out_dir, pattern))
             if os.path.isfile(p) and not p.endswith((TMP_SUFFIX, ".meta.json"))]
    if not cands:
        return None, {}
    newest = max(cands, key=os.path.getmtime)
    return newest, load_meta(newest)
