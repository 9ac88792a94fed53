"""Where a CFG decode's time goes on the GPU (counterpart of the JAX
package's ``scripts/profile_decode.py``):

    python -m var_tpu_torch.apps.profile_decode --depth 16 --batch 8 \
        [--cache chunked|prealloc|concat] [--kv_window W]

Builds d``depth`` with seeded random weights and the main-path sampler
(256px, bf16, cfg 1.5, top_k 900, top_p 0.96; the chunked cache unless
``--cache`` or ``--kv_window`` asks for the one ``flash_decode_paired``
serves), whose first call warms up and captures the decode into a CUDA
graph (``engine/sampler.py::make_sampler``), then:

* times the eager token decode and the VQVAE render separately (host
  clock around work that ends in ``torch.cuda.synchronize()``);
* traces one replay of the captured sampler and one eager ``decode_cfg``
  under ``torch.profiler`` and prints one JSON line with, for each: wall
  time, device-busy time (sum of the device events' self time) and idle
  share, device time grouped by kind (the port's decode kernels, rows 1-4
  of the kernel table in PERF.md; GEMMs, convolutions, the rest) and the
  top kernels by device time; beside them the capture's seconds and the
  launches a decode makes, as the capture recorded them.

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
    from var_tpu_torch.engine.sampler import (decode_cfg, decode_tokens_cfg, make_sampler,
                                              render_fhat)
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
    sampler(var, vae, gen, labels)  # warm-up (kernel build, cuBLAS/cuDNN plans) and capture
    entry = sampler.graphs[(args.batch, False)]
    label_t = torch.as_tensor(labels, device=dev)
    with torch.inference_mode():
        decode_cfg(var, vae, label_t, gen, **kw)  # the eager path's warm-up on this stream
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, f_hat = decode_tokens_cfg(var, vae, label_t, gen, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        render_fhat(vae, f_hat, dtype)
        torch.cuda.synchronize()
        t2 = time.perf_counter()

    def eager():
        with torch.inference_mode():
            decode_cfg(var, vae, label_t, gen, **kw)

    def traced(fn) -> dict:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
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
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "by_kind": by_kind,
                "device_events": sum(r[1] for r in rows),
                "top": [{"name": n[:90], "count": c, "ms": us / 1e3}
                        for n, c, us in rows[:args.top]]}

    replay = traced(lambda: sampler(var, vae, gen, labels))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "depth": args.depth, "batch": args.batch,
        "cache": args.cache, "kv_window": args.kv_window,
        "decode_tokens_ms": (t1 - t0) * 1e3, "render_ms": (t2 - t1) * 1e3,
        "capture_s": entry.capture_s,
        "launches_per_decode": {k: v for k, v in entry.launches.items() if v},
        "replay": replay, "eager": traced(eager),
    }))


if __name__ == "__main__":
    main()
