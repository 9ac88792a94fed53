"""How captures fare under a live NCCL process group, by capture error mode:

    python -m var_tpu_torch.apps.probe_nccl_capture --trials 8

``engine/compiled.py`` captures a program whose body runs NCCL
collectives in torch's default ``capture_error_mode="global"``.
ProcessGroupNCCL's watchdog thread queries the CUDA events of earlier
collectives while a capture runs, and under that mode a query from
another thread could count against the capture, where
``"thread_local"`` would not. This probe measures whether it does. For
each mode, in a process of its own (a CUDA error in the
watchdog may end the process), it joins a one-process NCCL world through a
file store, builds a mesh with a one-rank NCCL group on each axis, and
runs ``--trials`` rounds of ``apps/dryrun_multigpu.py``'s held cases (two
training steps, a greedy decode and an eval batch, each a new program
whose first call runs its collectives eagerly, then captures at once) on
the dry run's small GPU configuration, or with ``--full`` at the d16
width (C 1024, 16 heads) and depth 4 over the ten 256px scales (the dry
run's small tokenizer). It prints, per mode, the captures
made, the rounds that raised, the first errors, the exit code and whether
every held call was bit-equal to its eager run. Needs one GPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

MODES = ("global", "thread_local")


def spec_of(full: bool) -> dict:
    from var_tpu_torch.apps import dryrun_multigpu as dry

    spec = dry.tiny_spec(1, "cuda", "nccl")
    if full:
        pns = [1, 2, 3, 4, 5, 6, 8, 10, 13, 16]
        spec["vae"]["v_patch_nums"] = spec["var"]["patch_nums"] = pns
        spec["var"].update(depth=4, embed_dim=1024, num_heads=16)
        spec["args"].update(depth=4, pn="_".join(map(str, pns)))
    return spec


def trial_rounds(mode: str, trials: int, full: bool) -> dict:
    """``trials`` rounds of the held cases with every capture in ``mode``."""
    import torch.distributed as dist

    from var_tpu_torch.apps import dryrun_multigpu as dry
    from var_tpu_torch.parallel import mesh as pm

    graph = torch.cuda.graph
    torch.cuda.graph = lambda *a, **k: graph(*a, **dict(k, capture_error_mode=mode))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="var_probe_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    out = {"mode": mode, "full": full, "captures": 0, "failed_rounds": 0, "errors": [], "held": True}
    try:
        mesh = pm.Mesh(1, 1, 0, 0, dist.new_group([0]), dist.new_group([0]))
        spec = spec_of(full)
        vae, var = dry.build_models(spec, dev)
        t0 = time.perf_counter()
        for _ in range(trials):
            try:
                got = dry.run_cases(spec, mesh, vae, var, dev)
            except Exception as e:  # noqa: BLE001 -- the count is the finding
                out["failed_rounds"] += 1
                out["errors"].append(repr(e)[:400])
                continue
            cases = [*got["train"].values(), *got["decode"].values(), got["eval"]]
            out["captures"] += sum(c["program"]["captured"] for c in cases)
            out["held"] &= all(all(c["program"]["held"]) for c in cases)
        out["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    out["errors"] = out["errors"][:3]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--full", action="store_true", help="the d16 width at depth 4, 10 scales")
    p.add_argument("--mode", choices=MODES, help=argparse.SUPPRESS)
    p.add_argument("--timeout", type=float, default=300.0)
    a = p.parse_args(argv)
    if a.mode:
        print(json.dumps(trial_rounds(a.mode, a.trials, a.full)), flush=True)
        return
    from var_tpu_torch.apps.dryrun_multigpu import ROOT
    from var_tpu_torch.device import resolve_device

    resolve_device("cuda")  # raises without a GPU

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for mode in MODES:
        try:
            run = subprocess.run([sys.executable, "-m", "var_tpu_torch.apps.probe_nccl_capture",
                                  "--mode", mode, "--trials", str(a.trials)]
                                 + ["--full"] * a.full,
                                 capture_output=True, text=True, timeout=a.timeout, env=env,
                                 cwd=ROOT)
            rc, stdout, stderr = run.returncode, run.stdout, run.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = "timeout", e.stdout or "", e.stderr or ""
        lines = [ln for ln in str(stdout).splitlines() if ln.startswith('{"mode"')]
        row = json.loads(lines[-1]) if lines else {"mode": mode}
        row.update(rc=rc, stderr_tail=str(stderr)[-600:] if rc != 0 else "")
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
