"""Where a CFG decode's time goes on the GPU (counterpart of the JAX
package's ``scripts/profile_decode.py``):

    python -m var_tpu_torch.apps.profile_decode --depth 16 --batch 8 \
        [--cache chunked|prealloc|concat] [--kv_window W]

Builds d``depth`` with seeded random weights, runs the main-path sampler
(256px, bf16, cfg 1.5, top_k 900, top_p 0.96; the chunked cache unless
``--cache`` or ``--kv_window`` asks for the one ``flash_decode_paired``
serves) once to warm up, then:

* times the token decode and the VQVAE render separately (host clock
  around work that ends in ``torch.cuda.synchronize()``);
* traces one whole sample under ``torch.profiler`` and prints one JSON line:
  wall time, device-busy time (sum of the device events' self time) and
  idle share,
  device time grouped by kind (the port's decode kernels, rows 1-4 of the
  kernel table in PERF.md; GEMMs, convolutions, the rest) and the top
  kernels by device time.

Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import time


def _kind(name: str) -> str:
    n = name.lower()
    if "decode_attention" in n:  # row 4 is the kPaired instantiation of row 2's kernels
        return "decode_attention_paired" if "<true" in n else "decode_attention"
    for kernel in ("modulated_ln", "topk_topp_bound"):
        if kernel in n:
            return kernel
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "conv"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "xmma" in n or "cublas" in n:
        return "gemm"
    return "other"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--cache", default="chunked", choices=("chunked", "prealloc", "concat"))
    p.add_argument("--kv_window", type=int, default=None)
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine.sampler import decode_tokens_cfg, make_sampler, render_fhat
    from var_tpu_torch.models import build_vae_var

    dev = resolve_device("cuda")
    dtype = torch.bfloat16
    vae_cfg, var_cfg, vae, var = build_vae_var(device=dev, seed=0, depth=args.depth,
                                               dtype=dtype)
    kw = dict(cfg_scale=1.5, top_k=900, top_p=0.96, dtype=dtype, kv_window=args.kv_window,
              cache_impl=args.cache)
    sampler = make_sampler(var_cfg, vae_cfg, device=dev, **kw)
    labels = [i * 97 % var_cfg.num_classes for i in range(args.batch)]
    gen = torch.Generator(device=dev).manual_seed(0)
    sampler(var, vae, gen, labels)  # warm-up (cuBLAS/cuDNN plans, kernel build)
    torch.cuda.synchronize()

    label_t = torch.as_tensor(labels, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        _, f_hat = decode_tokens_cfg(var, vae, label_t, gen, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        render_fhat(vae, f_hat, dtype)
        torch.cuda.synchronize()
        t2 = time.perf_counter()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        sampler(var, vae, gen, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t3) * 1e3

    rows = []  # device-side events only: kernels, memcpy, memset
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            rows.append((ev.key, ev.count, ev.self_device_time_total))
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows) / 1e3
    by_kind: dict = {}
    for name, count, us in rows:
        k = by_kind.setdefault(_kind(name), {"ms": 0.0, "launches": 0})
        k["ms"] += us / 1e3
        k["launches"] += count
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "depth": args.depth, "batch": args.batch,
        "cache": args.cache, "kv_window": args.kv_window,
        "decode_tokens_ms": (t1 - t0) * 1e3, "render_ms": (t2 - t1) * 1e3,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "by_kind": by_kind,
        "device_events": sum(r[1] for r in rows),
        "top": [{"name": n[:90], "count": c, "ms": us / 1e3} for n, c, us in rows[:args.top]],
    }))


if __name__ == "__main__":
    main()
