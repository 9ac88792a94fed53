"""What a generator gets for one run of one cell."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

from benchmark.harness import weights
from benchmark.reference import models as M


@dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    t0: float  # the process's start on the host clock
    device: object = None  # torch.device
    setup_s: Optional[float] = None
    rank: int = 0  # this process's rank of a cell on several cards
    world: int = 1
    mesh: object = None  # the program's data mesh (parallel/mesh.py) over the ranks
    host_group: object = None  # a gloo group for the host's decisions
    sizes: M.Sizes = field(init=False)

    def __post_init__(self):
        self.sizes = M.Sizes.from_config(self.config)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def empty_cache(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.empty_cache()

    def peak_bytes(self) -> int:
        """The most memory the run's allocator has held on the card."""
        import torch

        return int(torch.cuda.max_memory_reserved(self.device)) if self.cuda else 0

    def reference(self):
        """The reference networks over the seed's weights, made anew."""
        return M.build(self.sizes, weights.make(self.sizes, self.seed, self.device), self.device)

    def phase(self, name: str) -> None:
        """Log a set-up phase's end, in seconds since the process started."""
        import time

        self.log(f"setup: {name} done at {time.perf_counter() - self.t0:.2f} s")

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
