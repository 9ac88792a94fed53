"""Host cost of one decode-attention launch (rows 2 and 4), on the card.

Sampling is host-bound, so what one launch costs the host counts. This
times back-to-back calls of ``flash_decode`` (row 2, the q norm in the
launch) and ``flash_decode_paired`` (row 4, on a normalised (2B, Lq, C) q,
and, where the wrapper takes ``q_l2_scale_mul``, on the fused qkv with the
norm in the launch) at the first sampling stage (2B 16, Lq 1, Lk 1, bf16,
C 1024, 16 heads), where the host's issue time exceeds the device's, and at
the last (Lq 256, Lk 680). Per case: ``host_us``, the host clock per call
over ``--iters`` calls issued without a sync; ``call_ms``, CUDA events
around the same calls (the larger of host issue and device time); and,
where the library has it, ``encode_us``, the host time of the two
tensor-map encodings one bf16 launch makes, timed apart in C.

``--root`` imports ``var_tpu_torch`` from another checkout (an older tree
unpacked with ``git archive``), so that two trees are compared on one card
in one run. Run it as a file, not with ``-m``, so that ``--root`` decides
which package is imported:

    python var_tpu_torch/apps/decode_host_cost.py [--root DIR] [--iters 2000]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

C, HEADS, B2 = 1024, 16, 16
STAGES = {"first": (1, 1), "last": (256, 680)}


def _time(fn, iters: int) -> dict:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return {"host_us": host / iters * 1e6, "call_ms": start.elapsed_time(end) / iters}


def measure(iters: int) -> dict:
    import torch

    from var_tpu_torch.ops.cuda import build
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode, flash_decode_paired

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    lmax = max(lk for _, lk in STAGES.values())
    k = torch.randn(B2, lmax, C, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B2, lmax, C, generator=g, device=dev).to(torch.bfloat16)
    sm = torch.full((HEADS,), 4.0, device=dev)
    folds_norm = "q_l2_scale_mul" in inspect.signature(flash_decode_paired).parameters
    lib = build.lib()
    out = {}
    for stage, (lq, lk) in STAGES.items():
        qkv = torch.randn(B2, lq, 3 * C, generator=g, device=dev).to(torch.bfloat16)
        qn = qkv[..., :C].contiguous()
        cases = {"row2": lambda: flash_decode(qkv, k, v, lk, HEADS, 1.0, sm),
                 "row4_prenormed": lambda: flash_decode_paired(qn, k, v, HEADS, 1.0, lk=lk)}
        if folds_norm:
            cases["row4_norm_in_launch"] = lambda: flash_decode_paired(
                qkv, k, v, HEADS, 1.0, lk=lk, q_l2_scale_mul=sm)
        res = {name: _time(fn, iters) for name, fn in cases.items()}
        if hasattr(lib, "var_decode_tensor_maps_us"):
            res["encode_us"] = lib.var_decode_tensor_maps_us(
                k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), B2, lk, HEADS, iters)
        out[stage] = {"lq": lq, "lk": lk, **res}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose var_tpu_torch is imported")
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    import var_tpu_torch

    if not var_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"var_tpu_torch came from {var_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("decode_host_cost: needs a cuda device")
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "iters": args.iters, **measure(args.iters)}), flush=True)


if __name__ == "__main__":
    main()
