"""Shared pieces of the benchmark's CPU tests: a tiny configuration of the
same architecture, and traffic at sizes a test run holds."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load(rel: str) -> dict:
    return json.loads((ROOT / "benchmark" / rel).read_text())


@pytest.fixture
def tiny_config() -> dict:
    cfg = load("configs/var-d16.json")
    cfg.update(depth=2, embed_dim=128, num_heads=2, vocab_size=64, num_classes=10,
               patch_nums=[1, 2, 3, 4], drop_path_rate=0.05)
    cfg["vae"] = dict(cfg["vae"], ch=32)
    return cfg


@pytest.fixture
def tiny_sample_traffic() -> dict:
    t = load("traffic/fid50.json")
    t.update(batch=4, dtype="float32", greedy_every=2, check={"greedy": 1, "sampled": 1},
             top_k=20, trace_calls=1)
    return t


@pytest.fixture
def tiny_train_traffic() -> dict:
    t = load("traffic/train32.json")
    t.update(batch=4, dtype="float32", pool=4)
    return t


def cpu_context(config, traffic, seed=2 ** 31 + 11, seconds=1.0):
    import torch

    from benchmark.harness.context import Context

    return Context(seed=seed, seconds=seconds, trace=False, config=config, traffic=traffic,
                   t0=time.perf_counter(), device=torch.device("cpu"))


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
