"""Demo sampler (counterpart of ``var_tpu/apps/sample.py``; reference
``demo_sample.py``):

    python -m var_tpu_torch.apps.sample --depth 16 --vae_ckpt vae_ch160v4096z32.pth \\
        --var_ckpt var_d16.pth --out demo.png

Same flags and defaults as the JAX app (seed 0, cfg 4, top_k 900, top_p
0.95, the 8 demo classes), plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path). Decodes in bf16 on the GPU and in fp32 on the
CPU or with ``--fp32``. Without checkpoints it runs with seeded random
weights.
"""

from __future__ import annotations

import argparse
import os
import struct
import time
import zlib

import numpy as np


def save_grid(images: np.ndarray, path: str, per_row: int = 4) -> None:
    """images: (B, H, W, 3) in [0, 1] -> one tiled 8-bit RGB PNG (written
    with zlib, no imaging library needed)."""
    b, h, w, _ = images.shape
    rows = (b + per_row - 1) // per_row
    grid = np.zeros((rows * h, per_row * w, 3), np.uint8)
    arr = np.clip(images * 255.0, 0, 255).astype(np.uint8)
    for i in range(b):
        r, c = divmod(i, per_row)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = arr[i]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + grid[y].tobytes() for y in range(grid.shape[0]))
    ihdr = struct.pack(">IIBBBBB", grid.shape[1], grid.shape[0], 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--vae_ckpt", default="vae_ch160v4096z32.pth")
    p.add_argument("--var_ckpt", default="")
    p.add_argument("--pn", default="1_2_3_4_5_6_8_10_13_16")
    p.add_argument("--cfg", type=float, default=4.0)
    p.add_argument("--top_k", type=int, default=900)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--more_smooth", action="store_true")
    p.add_argument("--classes", default="980,980,437,437,22,22,562,562")  # demo_sample.py:64
    p.add_argument("--out", default="demo.png")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine.sampler import make_sampler
    from var_tpu_torch.models import build_vae_var

    dev = resolve_device(args.device)
    dtype = torch.float32 if (args.fp32 or dev.type == "cpu") else torch.bfloat16
    vae_cfg, var_cfg, vae, var = build_vae_var(
        device=dev, seed=args.seed, patch_nums=parse_patch_nums(args.pn), depth=args.depth,
        shared_aln=(args.depth == 36),  # d36-512 uses shared AdaLN (README.md:143)
        vae_ckpt=args.vae_ckpt if os.path.exists(args.vae_ckpt) else None,
        var_ckpt=args.var_ckpt if os.path.exists(args.var_ckpt) else None, dtype=dtype,
    )
    sampler = make_sampler(var_cfg, vae_cfg, cfg_scale=args.cfg, top_k=args.top_k,
                           top_p=args.top_p, more_smooth=args.more_smooth, dtype=dtype,
                           device=dev)
    labels = [int(c) for c in args.classes.split(",")]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    res = sampler(var, vae, gen, labels)
    image = res.image.cpu().numpy()  # waits for the device
    print(f"generated {len(labels)} images in {time.perf_counter() - t0:.2f}s on {dev} "
          f"(incl. the kernel build on a first GPU call)")
    save_grid(image, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
