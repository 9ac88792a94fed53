"""Inpainting, outpainting and box-editing app (counterpart of
``var_tpu/apps/inpaint.py``; reference ``inpainting.py`` and the zero-shot
edit notebook):

    python -m var_tpu_torch.apps.inpaint --data_path <folder of class subdirs> \\
        --var_ckpt var_d16.pth --keep_through 6

Per input image: tokenize with the VQVAE, build a keep-mask, decode with the
ground truth forced at kept positions, save ``{i}_original.png`` and
``{i}_inpainted_{label}.png``. Mask recipes:

* ``--keep_through K``: keep scales 0..K, regenerate the rest (default 6,
  the fork's recipe, ``inpainting.py:347-348``);
* ``--target_layer T --patches "i,j;i,j"``: patch masks at scale T carried
  to later scales (``inpainting.py:48-100``); ``--reverse`` flips them;
* ``--box "y0,x0,y1,x1"``: embedding-space box editing (the notebook's
  ``get_edit_mask``/``replace_embedding``); ``--outpaint`` keeps only the
  box. The decode gets the edit mask and no keep-mask: the JAX app also
  passes an all-True keep-mask here, which forces every token to the ground
  truth, so its box mode returns the tokenizer's reconstruction.

The tokenizer and the decode are compiled, as the JAX app jits them: on
CUDA the first image captures each into a CUDA graph and every later image
replays it (``engine/compiled.py``); one capture serves every image of a
mask or a box. Same flags and defaults as the JAX app (cfg 4.0, top_k 1),
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Decodes in bf16 on the GPU and in fp32 on the CPU. Reading images needs
Pillow; without checkpoints the models have seeded random weights.
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
    p.add_argument("--data_path", required=True, help="folder of class subdirs")
    p.add_argument("--out_dir", default="inpaint_out")
    p.add_argument("--cfg", type=float, default=4.0)
    p.add_argument("--top_k", type=int, default=1)  # inpainting.py:351 uses top_k=1
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label", type=int, default=-1, help="-1: use folder label")
    p.add_argument("--keep_through", type=int, default=6)
    p.add_argument("--target_layer", type=int, default=-1)
    p.add_argument("--patches", default="", help='e.g. "2,3;4,1"')
    p.add_argument("--reverse", action="store_true")
    p.add_argument("--box", default="", help='"y0,x0,y1,x1" in [0,1] -> edit-mask mode')
    p.add_argument("--outpaint", action="store_true")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from var_tpu_torch.apps.masks import (generate_inpainting_mask, get_edit_mask,
                                          keep_scales_mask)
    from var_tpu_torch.apps.sample import save_grid
    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.data.imagenet import FolderDataset, make_transform
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine.sampler import make_sampler
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

    if args.box:
        y0, x0, y1, x1 = [float(v) for v in args.box.split(",")]
        mask = get_edit_mask(pns, y0, x0, y1, x1, inpainting=not args.outpaint)
    elif args.target_layer >= 0:
        coords = [tuple(int(v) for v in c.split(",")) for c in args.patches.split(";") if c]
        mask = generate_inpainting_mask(pns, args.target_layer, coords, args.reverse)[None]
    else:
        mask = keep_scales_mask(pns, args.keep_through)[None]
    # one compiled decode and one compiled tokenizer, as the JAX app jits them
    decode = make_sampler(var_cfg, vae_cfg, cfg_scale=args.cfg, top_k=args.top_k,
                          top_p=args.top_p, dtype=dtype, device=dev,
                          inpainting=not args.box, editing=bool(args.box))
    tokenize = make_tokenizer(dev)

    rng_np = np.random.default_rng(args.seed)
    for idx in range(min(args.limit, len(ds))):
        path, label = ds.samples[idx]
        img = torch.from_numpy(tf(path, rng_np))[None].to(dev)
        lab = args.label if args.label >= 0 else label
        with torch.inference_mode():
            gt = torch.cat(tokenize.static(vae, img), dim=1)
        res = decode(var, vae, torch.Generator(device=dev).manual_seed(args.seed + idx), [lab],
                     gt, mask)
        save_grid((img * 0.5 + 0.5).cpu().numpy(),
                  os.path.join(args.out_dir, f"{idx}_original.png"), per_row=1)
        save_grid(res.image.cpu().numpy(),
                  os.path.join(args.out_dir, f"{idx}_inpainted_{lab}.png"), per_row=1)
        print(f"[{idx}] label={lab} saved")


if __name__ == "__main__":
    main()
