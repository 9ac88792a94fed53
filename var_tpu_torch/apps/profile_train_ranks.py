"""The training CLI's loop on every rank of a torchrun group, its programs
compiled against eager:

    torchrun --nproc_per_node 4 -m var_tpu_torch.apps.profile_train_ranks
    torchrun --nproc_per_node 2 -m var_tpu_torch.apps.profile_train_ranks \\
        --device cpu --depth 2 --pn 1_2_3 --bs 4 --steps 2

Each rank joins the group as ``apps/train.py`` does (NCCL on GPUs, gloo
with ``--device cpu``) with the CLI's mesh, pure data parallelism
(``make_mesh()``), and runs ``apps/train.py::train`` over synthetic
datasets of numpy images made from the loader's per-sample streams, the
tokenizer (``VAR_TPU_VAE_CKPT``, else seeded weights) and the VAR from
seeded weights: by default the published d16
at 256px, ``--bs`` 32 rows a rank, fp16=1, remat 2, tclip 2, ``--attn
auto``, ``--ep`` epochs of ``--steps`` steps, an eval at the end, no
checkpoint written. Run A calls the programs as the CLI does (under NCCL
the step and the eval replay CUDA graphs in one memory pool); run E runs
the same loop with every program's body called eagerly
(``Compiled.eager``). Each rank prints one JSON line: for each run, the
ms a step (the median after the first), ``data_t``, the eval seconds, the
val stats, the peak reserved GB from an emptied cache, and the captures
(seconds, pool GB) the run made.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch


class _SynthImages:
    """``samples[i]`` is (i, a seeded label); the image comes from the
    loader's per-sample stream (:func:`_image`)."""

    def __init__(self, n: int, seed: int):
        labels = np.random.default_rng([seed, n]).integers(0, 1000, n)
        self.samples = [(i, int(lbl)) for i, lbl in enumerate(labels)]

    def __len__(self):
        return len(self.samples)


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(args, steps: int, dev, attn, vae, var, mesh, eager: bool) -> dict:
    """One call of the CLI's loop over ``steps`` batches an epoch: its
    times, val stats, peak reserved GB and captures."""
    from var_tpu_torch.apps import train as train_app
    from var_tpu_torch.engine import checkpoint as ckpt
    from var_tpu_torch.engine.compiled import Compiled, CompiledEntry

    reso = args.patch_nums[-1] * 16
    n_train = args.batch_size * mesh.dp * steps

    def image(item, rng):
        return rng.random((reso, reso, 3), dtype=np.float32) * 2 - 1

    train_iter, iters, val_batches = train_app.make_loaders(
        args, _SynthImages(n_train, 0), _SynthImages(args.batch_size * mesh.dp, 1), 0, 0, image,
        image, world_size=mesh.dp, rank=mesh.data_rank)
    captures = []
    capture, static, save = CompiledEntry.capture, Compiled.static, ckpt.save_checkpoint

    def logged(entry, *a):
        capture(entry, *a)
        captures.append([entry.capture_s, entry.pool_bytes / 1e9])

    CompiledEntry.capture = logged
    ckpt.save_checkpoint = lambda *a, **k: None
    if eager:
        Compiled.static = lambda program, *a, generator=None: program.eager(*a,
                                                                           generator=generator)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        _, times = train_app.train(args, dev, attn, vae, var, train_iter, iters, val_batches,
                                   mesh=mesh)
    finally:
        CompiledEntry.capture, Compiled.static, ckpt.save_checkpoint = capture, static, save
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"run_s": time.perf_counter() - t0, "step_s": times["step_t"],
            "step_ms_median_after_first": 1e3 * float(np.median(times["step_t"][1:])),
            "data_t_s": times["data_t"], "eval_s": times["eval_s"], "val": times["val"],
            "peak_reserved_gb": (torch.cuda.max_memory_reserved(dev) / 1e9
                                 if dev.type == "cuda" else None),
            "captures_s_gb": captures, "finite": all(bool(torch.isfinite(p).all())
                                                     for p in var.parameters())}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--pn", default="1_2_3_4_5_6_8_10_13_16")
    p.add_argument("--bs", type=int, default=32, help="rows a rank")
    p.add_argument("--steps", type=int, default=3, help="steps an epoch")
    p.add_argument("--ep", type=int, default=2)
    a = p.parse_args(argv)

    from var_tpu_torch.apps import train as train_app
    from var_tpu_torch.config import TrainArgs, resolve_attn
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.parallel import mesh as pm

    pm.initialize_distributed("gloo" if a.device == "cpu" else None)
    mesh = pm.make_mesh()
    dev = resolve_device(a.device)
    out_dir = tempfile.mkdtemp(prefix="var_train_ranks_")
    args = TrainArgs(depth=a.depth, bs=a.bs * mesh.dp, ac=1, ep=a.ep, fp16=1, tclip=2.0,
                     remat=2, seed=0, attn="auto", pn=a.pn, val_freq_ep=a.ep, ckpt_iters=0,
                     allow_random_vae=1, workers=4,
                     local_out_dir_path=out_dir).finalize(world_size=mesh.dp)
    attn = resolve_attn(args.attn, dev)
    report = {"rank": 0 if mesh.dp == 1 else mesh.data_rank, "world": mesh.dp,
              "backend": str(torch.distributed.get_backend())
              if torch.distributed.is_initialized() else None,
              "card": _card() if dev.type == "cuda" else None, "depth": a.depth,
              "batch_a_rank": a.bs, "capturable": pm.capturable(mesh)}
    for name, eager in (("A", False), ("E", True)):
        vae, var = train_app.build_models(args, dev)  # the same seeded weights each run
        report[name] = run(args, a.steps, dev, attn, vae, var, mesh, eager)
        del vae, var
    print(json.dumps(report), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
