"""Smooth-sampling app (counterpart of ``var_tpu/apps/smooth.py``;
reference ``smoothing.py``):

    python -m var_tpu_torch.apps.smooth --data_path <folder of class subdirs> \\
        --var_ckpt var_d16.pth --n 4096

Per image: tokenize, regenerate constrained to codebook neighbours of the
ground-truth tokens (``smooth_sampling``; ``--threshold`` switches from the
candidate-count mode to the L2-threshold mode), save
``{i}_smoothed_{label}.png`` and print the model and distance
log-likelihoods (``smoothing.py:352-369``). The tokenizer and
``smooth_sampling`` are compiled, as the JAX app jits them: on CUDA the
first image captures each into a CUDA graph and later images replay it
(``engine/compiled.py``). Same flags and defaults as the JAX app, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). The
transformer runs in bf16 on the GPU and in fp32 on the CPU. Reading
images needs Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--vae_ckpt", default="vae_ch160v4096z32.pth")
    p.add_argument("--var_ckpt", default="")
    p.add_argument("--pn", default="1_2_3_4_5_6_8_10_13_16")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_dir", default="smooth_out")
    p.add_argument("--cfg", type=float, default=1.5)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--threshold", type=float, default=None,
                   help="L2 neighbor threshold; None = candidate-count mode")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label", type=int, default=-1)
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from var_tpu_torch.apps.sample import save_grid
    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.data.imagenet import FolderDataset, make_transform
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine.sampler import make_smooth_sampler
    from var_tpu_torch.models import build_vae_var
    from var_tpu_torch.models.vae import make_tokenizer

    dev = resolve_device(args.device)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    pns = parse_patch_nums(args.pn)
    vae_cfg, var_cfg, vae, var = build_vae_var(
        device=dev, patch_nums=pns, depth=args.depth,
        vae_ckpt=args.vae_ckpt if os.path.exists(args.vae_ckpt) else None,
        var_ckpt=args.var_ckpt if os.path.exists(args.var_ckpt) else None, dtype=dtype)
    tf = make_transform(pns[-1] * vae_cfg.downsample, train=False)
    ds = FolderDataset(args.data_path)
    os.makedirs(args.out_dir, exist_ok=True)
    smooth = make_smooth_sampler(args.n, cfg_scale=args.cfg, neighbor_threshold=args.threshold,
                                 dtype=dtype, device=dev)
    tokenize = make_tokenizer(dev)

    rng_np = np.random.default_rng(args.seed)
    for idx in range(min(args.limit, len(ds))):
        path, label = ds.samples[idx]
        img = torch.from_numpy(tf(path, rng_np))[None].to(dev)
        lab = args.label if args.label >= 0 else label
        with torch.inference_mode():
            gt = torch.cat(tokenize.static(vae, img), dim=1)
        res = smooth(var, vae, gt, [lab])
        save_grid(res.image.cpu().numpy(),
                  os.path.join(args.out_dir, f"{idx}_smoothed_{lab}.png"), per_row=1)
        ll, dll = float(res.log_likelihood), float(res.distance_log_likelihood)
        print(f"[{idx}] label={lab} log_lik={ll:.2f} dist_log_lik={dll:.2f} sum={ll + dll:.2f}")


if __name__ == "__main__":
    main()
