"""Where a VQVAE tokenizer-training step's time goes on the GPU:

    python -m var_tpu_torch.apps.profile_vae_train --batch 8 --gn dot
    python -m var_tpu_torch.apps.profile_vae_train --batch 8 --gn pallas

Builds the published ch160 tokenizer (``VAEConfig()``: ch_mult (1, 1, 2, 2,
4), V 4096, Cvae 32, the 256px pyramid) with seeded random weights, float32,
and the chip-smoke training configuration (lr 3e-4, tclip 2; ``--gn`` the
GroupNorm impl, "pallas" through row 7's kernel), runs two warm-up steps on
seeded random 256px images, then:

* times ``--steps`` steps, replays of the compiled step's CUDA graph (host
  clock around work that ends in ``torch.cuda.synchronize()``);
* traces one replayed step under ``torch.profiler`` and prints one JSON
  line (under ``eager``, the same for the step run eagerly): wall time,
  device-busy time (the device events' self time) and idle share, device
  time grouped by kind (convolutions, GroupNorm, elementwise,
  optimizer, the rest; GroupNorm holds row 7 and ``F.group_norm``'s own
  kernels, while the "pallas" apply step counts as elementwise) and the top
  kernels by device time, with the TF32 flags and peak memory.

Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import time


def _kind(name: str) -> str:
    n = name.lower()
    if any(w in n for w in ("gn_stats", "groupnorm", "group_norm", "rowwisemoments",
                            "fusedparams", "internalgradients", "gammabeta")):
        return "group_norm"  # row 7 and F.group_norm's kernels; the "pallas" apply: elementwise
    if any(w in n for w in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "fft")):
        return "conv"  # cuDNN also convolves through FFT kernels
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"  # the foreach AdamW, clip and norm kernels
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "cublas" in n:
        return "gemm"  # the attention blocks' bmm and the codebook lookups
    if "elementwise" in n or "reduce" in n or "upsample" in n or "pad" in n:
        return "elementwise"
    return "other"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--gn", default="dot", help="GroupNorm impl: dot|xla|pallas")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)

    import torch

    from var_tpu_torch.config import VAEConfig
    from var_tpu_torch.engine.vae_trainer import make_vae_train_step
    from var_tpu_torch.models import build_vae_train
    from var_tpu_torch.utils.profiling import device_events

    cfg = VAEConfig()
    vae = build_vae_train(device="cuda", seed=0, cfg=cfg)
    dev = vae.quantize.embedding.weight.device
    init_state, step = make_vae_train_step(cfg, lr=3e-4, tclip=2.0, gn_impl=args.gn)
    state = init_state(vae)
    reso = cfg.v_patch_nums[-1] * cfg.downsample
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand(args.batch, reso, reso, 3, generator=g, device=dev) * 2 - 1

    def run_step(eager: bool = False):
        nonlocal state
        state, m = (step.eager if eager else step)(state, img)
        return m

    for _ in range(2):  # warm-up (cuDNN plans, kernel build), then the capture
        run_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        m = run_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

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
    median = times[len(times) // 2]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch, "gn_impl": args.gn,
        "ch": cfg.ch, "ch_mult": list(cfg.ch_mult), "vocab_size": cfg.vocab_size,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "step_ms": [t * 1e3 for t in times], "step_ms_median": median * 1e3,
        "img_per_s": args.batch / median, "loss": float(m["loss"]),
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
