"""Device time of rows 1 and 3 (``modulated_layernorm``, ``topk_topp_bound``)
at every stage shape of the d16 CFG decode, on the card.

The decode launches row 3 once per stage on (B pn^2, V) fp32 logits and
row 1 2 x depth times per stage on (2B, pn^2, C) bf16 rows, for pn in the
10-scale pyramid. Most stages launch fewer rows than the card has SMs, so a
kernel's time at the last stage alone says little of what a batch pays.
This times each kernel at each stage (``torch.profiler`` device time per
call) on seeded inputs (B 8, C 1024, V 4096, top_k 900, top_p 0.96; row 3
also at top_k 1, as inpainting samples) and sums each over a batch.

``--root`` imports ``var_tpu_torch`` from another checkout (an older tree
unpacked with ``git archive``), so that two trees are compared on one card
in one run. Run it as a file, not with ``-m``, so that ``--root`` decides
which package is imported:

    python var_tpu_torch/apps/stage_kernels.py [--root DIR] [--iters 50]

Prints one JSON line. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PATCH_NUMS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
BATCH, C, V, DEPTH = 8, 1024, 4096, 16
TOP_K, TOP_P = 900, 0.96


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the self time of every device event
    it launches, from ``torch.profiler``, after two warm-up calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3 / iters


def measure(iters: int) -> dict:
    import torch

    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
    from var_tpu_torch.ops.cuda.select import topk_topp_bound

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    p6 = torch.randn(2 * BATCH, 6, C, generator=g, device=dev) * 0.3
    scale, shift = p6[:, 2], p6[:, 4]  # strided rows, as on the main path
    ln, sel, sel_k1 = [], [], []
    for pn in PATCH_NUMS:
        x = (torch.randn(2 * BATCH, pn * pn, C, generator=g, device=dev) * 2 + 0.5)
        x = x.to(torch.bfloat16)
        logits = torch.randn(BATCH * pn * pn, V, generator=g, device=dev) * 3
        ln.append(device_ms(lambda: modulated_layernorm(x, scale, shift), iters))
        sel.append(device_ms(lambda: topk_topp_bound(logits, TOP_K, TOP_P), iters))
        sel_k1.append(device_ms(lambda: topk_topp_bound(logits, 1, TOP_P), iters))
    return {"modulated_layernorm_ms": ln, "modulated_layernorm_per_batch_ms": 2 * DEPTH * sum(ln),
            "topk_topp_bound_ms": sel, "topk_topp_bound_per_batch_ms": sum(sel),
            "topk_topp_bound_k1_ms": sel_k1}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=None, help="checkout whose var_tpu_torch to import")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    root = Path(args.root).resolve() if args.root else Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))

    import torch

    from var_tpu_torch.device import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "root": str(root), "stage_rows_select": [BATCH * n * n for n in PATCH_NUMS],
                      "stage_rows_ln": [2 * BATCH * n * n for n in PATCH_NUMS],
                      **measure(args.iters)}))


if __name__ == "__main__":
    main()
