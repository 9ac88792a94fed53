"""Run one cell of the benchmark once and print its result as the last line
of standard output::

    python3 benchmark/run.py --workload d16-fid50 --seed 7 --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the mix's ``kind`` picks the generator that loads the
program (``var_tpu_torch``), warms up every shape it will use, measures for
``--seconds``, and then holds what the program produced to the plain
reference. ``--trace 1`` traces a few calls of the window under
``torch.profiler`` and reports the per-layer metrics in place of the
end-to-end ones. Needs the cards the cell asks for; without them it exits
with 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "var_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and every limit read."""
    checks = {n: {"value": numbers.get(n), "limit": lim} for n, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(reg, cell: dict, out: dict, correct: bool, checks: dict, args, device: dict,
                run_view) -> dict:
    """The last line's object; ``checks`` comes last."""
    metrics = {}
    if args.trace:
        for m in reg.metrics(cell["name"], "per_layer"):
            v = reg.reader(m["name"])(run_view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in reg.metrics(cell["name"], "end_to_end"):
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    tr = out.get("trace")
    if args.trace and tr is not None:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": [[n[:160], v] for n, v in tr.top_ops],
                             "idle_gaps": [[n[:160], v] for n, v in tr.idle_by_host]}
    line["checks"] = checks
    return line


class RunView:
    """What a per-layer metric's reader sees of one traced run."""

    def __init__(self, ctx, cell: dict, out: dict):
        self.sizes, self.traffic, self.cell = ctx.sizes, ctx.traffic, cell
        self.trace = out.get("trace")
        self.capture_s = out.get("capture_s")
        self.peak_bytes = out.get("peak_bytes")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness.context import Context
    from benchmark.harness.registry import Registry

    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    # caches at fixed paths inside the checkout (the kernels' library is
    # built by the program into var_tpu_torch/ops/cuda/_build/)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / "out" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "benchmark" / "out" / "torch_ext"))

    import torch

    from benchmark.harness import ranks

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    is_rank = ranks.RANK_ENV in os.environ
    if cell["chips"] > 1 and not is_rank:
        return ranks.launch(__file__, sys.argv[1:] if argv is None else argv, cell["chips"],
                            time.time() - (time.perf_counter() - T0))
    torch.set_num_threads(4)
    ctx = Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  config=reg.config(cell["config"]), traffic=reg.traffic(cell["traffic"]),
                  t0=ranks.rank_t0() if is_rank else T0, device=torch.device("cuda", 0))
    if is_rank:
        ranks.join(ctx)
    torch.cuda.reset_peak_memory_stats()
    limit = power_limit()
    out = reg.generator(ctx.traffic["kind"]).run(ctx)
    ranks.leave(ctx)
    if ctx.rank != 0:
        return 0
    correct, checks = judge(out["numbers"], reg.limits(cell["name"]))
    for name, v in out["numbers"].items():
        if name not in checks:  # read, not judged
            print(f"number {name}: {v}", file=sys.stderr)
    want = ctx.traffic.get("check", {})
    for key, n in want.items():  # a check that drew fewer requests than it asks for failed
        if out.get("checked", want).get(key, 0) < n:
            correct = False
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["peak_bytes"], "power_limit": limit}
    line = result_line(reg, cell, out, correct, checks, args, device, RunView(ctx, cell, out))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
