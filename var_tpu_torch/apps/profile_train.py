"""Where a training step's time goes on the GPU (the training counterpart of
``apps/profile_decode.py``):

    python -m var_tpu_torch.apps.profile_train --depth 16 --batch 32
    python -m var_tpu_torch.apps.profile_train --pn 512 --batch 8 --attn pallas

Builds d``depth`` with seeded random weights and the chip-smoke training
configuration (``--pn`` patch numbers, 256px by default; bf16 compute with
fp32 parameters, remat 2, tclip 2, fp16=1; ``--attn`` resolved as the
training CLI resolves it), runs two warm-up steps on seeded random images,
then:

* times steps (replays of the compiled step's CUDA graph) and the frozen
  tokenizer alone (host clock around work that ends in
  ``torch.cuda.synchronize()``);
* traces one replayed step under ``torch.profiler`` and prints one JSON
  line: wall time, device-busy time (the device events' self time) and
  idle share, device time grouped by kind (the training-attention kernels
  of rows 5 and 6, GEMMs, convolutions, the rest) and the top kernels by
  device time; under ``eager``, the same step run eagerly (``step.eager``):
  its median ms, one traced step's wall, busy ms and idle share.

Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import time


def _kind(name: str) -> str:
    """The kind a device kernel's time is grouped under, from its name as
    the profiler (demangled) or ``cuobjdump`` (mangled) prints it."""
    n = name.lower()
    # the kernels' kRow: <5> demangled, ILi5E mangled
    row = "flash_attention" if "<5>" in n or "ili5e" in n else "paired_train"
    if "ptrain_fwd" in n:
        return f"{row}_fwd"
    if "ptrain_dq" in n or "ptrain_dkv" in n:
        return f"{row}_bwd"
    if any(w in n for w in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "fft")):
        return "conv"  # cuDNN also convolves through FFT kernels
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "xmma" in n or "cublas" in n:
        return "gemm"
    return "other"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--pn", default="256", help="patch numbers: 256, 512, 1024 or 1_2_3...")
    p.add_argument("--attn", default="auto", help="auto|xla|pallas|hybrid|paired")
    args = p.parse_args(argv)

    import torch

    from var_tpu_torch.config import TrainArgs, parse_patch_nums, resolve_attn
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import build_vae_var_train
    from var_tpu_torch.utils.profiling import device_events

    dev = resolve_device("cuda")
    attn = resolve_attn(args.attn, dev)
    targs = TrainArgs(depth=args.depth, bs=args.batch, ac=1, ep=200, fp16=1, tclip=2.0,
                      remat=2, seed=0, pn=args.pn).finalize(world_size=1)
    vae_cfg, var_cfg, vae, var = build_vae_var_train(device=dev, seed=0, depth=args.depth,
                                                     patch_nums=parse_patch_nums(args.pn))
    init_state, step = tr.make_train_step(var_cfg, vae_cfg, targs, iters_per_ep=1000,
                                          dtype=torch.bfloat16, attn_impl=attn)
    state = init_state(var)
    g = torch.Generator(device=dev).manual_seed(1)
    reso = var_cfg.patch_nums[-1] * vae_cfg.downsample
    imgs = torch.rand(1, args.batch, reso, reso, 3, generator=g, device=dev) * 2 - 1
    labels = torch.randint(0, var_cfg.num_classes, (1, args.batch), generator=g, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    it = 0

    def run_step(eager: bool = False):
        nonlocal state, it
        state, m = (step.eager if eager else step)(state, vae, imgs, labels, gen, it, 1.0)
        it += 1
        return m

    for _ in range(2):  # warm-up (cuBLAS/cuDNN plans, kernel build), then the capture
        run_step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    tr.tokenize(vae, imgs[0], targs)
    torch.cuda.synchronize()
    tokenize_ms = (time.perf_counter() - t0) * 1e3

    wall_ms, rows = device_events(run_step)
    busy_ms = sum(r[2] for r in rows) / 1e3
    eager_wall_ms, eager_rows = device_events(lambda: run_step(eager=True))
    eager_busy_ms = sum(r[2] for r in eager_rows) / 1e3
    eager_times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run_step(eager=True)
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
    eager_times.sort()
    by_kind: dict = {}
    for name, count, us in rows:
        k = by_kind.setdefault(_kind(name), {"ms": 0.0, "launches": 0})
        k["ms"] += us / 1e3
        k["launches"] += count
    times.sort()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "depth": args.depth, "batch": args.batch,
        "patch_nums": list(var_cfg.patch_nums), "attn": attn,
        "step_ms": [t * 1e3 for t in times], "step_ms_median": times[len(times) // 2] * 1e3,
        "img_per_s": args.batch / times[len(times) // 2], "tokenize_ms": tokenize_ms,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "by_kind": by_kind,
        "device_events": sum(r[1] for r in rows),
        "eager": {"step_ms_median": eager_times[len(eager_times) // 2] * 1e3,
                  "profiled_wall_ms": eager_wall_ms, "device_busy_ms": eager_busy_ms,
                  "idle_share": max(0.0, 1.0 - eager_busy_ms / eager_wall_ms),
                  "device_events": sum(r[1] for r in eager_rows)},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "top": [{"name": n[:90], "count": c, "ms": us / 1e3} for n, c, us in rows[:args.top]],
    }))


if __name__ == "__main__":
    main()
