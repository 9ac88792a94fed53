"""The readings that the check's limits are set from, for one cell on
several seeds in one process (the benchmark's own runs never run this)::

    python3 benchmark/control.py --workload d16-fid50 --seeds 11,12,13 --seconds 5

For each seed, one JSON line on standard output with:

* ``program``: the numbers the check compares (``harness/check.py``) for a
  short window of the cell at its own load and sizes: the lower readings;
* ``control``: the same numbers with the reference computed with float8
  e4m3 operands (the nearest precision below the configuration's bfloat16)
  put in the program's place: the upper readings;
* training cells also ``half_batch``: the float32 reference with half of
  each batch left out, the mean taken over the rest, in the program's place.
  (A step that leaves its state unchanged reads 1 on ``change_gap`` by its
  definition, and needs no run.)

A cell on several cards reads its program numbers from its own runs (their
``checks``); here its reference readings run in one process over the global
batch.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(reg, cell: dict, seed: int, seconds: float, device) -> dict:
    from benchmark.harness import check
    from benchmark.harness.context import Context
    from benchmark.harness.train import reference_steps
    from benchmark.reference.models import PRECISIONS

    fp8 = PRECISIONS["float8_e4m3"]
    ctx = Context(seed=seed, seconds=seconds, trace=False, config=reg.config(cell["config"]),
                  traffic=reg.traffic(cell["traffic"]), t0=time.perf_counter(), device=device,
                  world=cell["chips"])
    row = {"seed": seed}
    if cell["chips"] == 1:
        out = reg.generator(ctx.traffic["kind"]).run(ctx)
        row.update(program=out["numbers"], e2e=out["e2e"])
        gc.collect()
        ctx.empty_cache()
    if ctx.traffic["kind"] == "sample":
        ref_vae, ref_var = ctx.reference()
        row["control"] = check.sample_numbers(ref_vae, ref_var, ctx.traffic, out["served"], fp8,
                                              seed=seed)
    else:
        want = reference_steps(ctx)
        row["control"] = check.train_numbers(reference_steps(ctx, fp8), want)
        row["half_batch"] = check.train_numbers(
            reference_steps(ctx, keep_rows=ctx.traffic["batch"] * ctx.world // 2), want)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.registry import Registry

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(readings(reg, cell, seed, args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
