"""FID sampling protocol (counterpart of ``var_tpu/apps/fid_sample.py``;
reference ``README.md:151-157``)::

    python -m var_tpu_torch.apps.fid_sample --var_ckpt var_d16.pth --rounds 4 --pack

Samples ``per_class`` images for each of ``num_classes`` classes with the
benchmark recipe (cfg 1.5, top_p 0.96, top_k 900, no smoothing), writes
``{i:06d}.png`` files (Pillow), and packs them into the OpenAI-evaluator npz
through ``utils/logging.py::create_npz_from_sample_folder`` (reference
``utils/misc.py:360-381``). Kill/resume-safe: a chunk whose PNGs all exist
is skipped, and its generator seed is still consumed, so a resumed run
draws what the uninterrupted run drew. ``--device`` defaults to ``cuda``
(bf16 decode); ``cpu`` runs the plain PyTorch path in float32.

:func:`decode_chunks` is the decode loop without the files: it yields
``(first_index, uint8 images)`` per chunk.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def decode_chunks(var, vae, labels_all: np.ndarray, batch: int, rounds: int = 1,
                  seed: int = 0, cfg_scale: float = 1.5, top_k: int = 900, top_p: float = 0.96,
                  dtype: torch.dtype = torch.bfloat16, device="cuda",
                  done: Optional[Callable[[int, int], bool]] = None
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """Decode ``labels_all`` in chunks of ``rounds * batch`` images
    (``engine/sampler.py::make_scan_sampler`` when ``rounds`` > 1, else
    ``make_sampler``; on CUDA both replay one captured decode, and the
    ragged tail's batch size is a capture of its own) and yield
    ``(first_index, (n, H, W, 3) uint8)`` per chunk. Chunk k draws from
    ``torch.Generator(device).manual_seed(seed + k + 1)`` (JAX:
    ``PRNGKey(seed + rng_i)``). A ragged tail under
    ``rounds`` > 1 falls back to per-batch decodes. ``done(i, n)``: True
    when images i..i+n-1 exist already; such a chunk is skipped (its seed
    is still consumed)."""
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine.sampler import make_sampler, make_scan_sampler

    if batch < 1 or rounds < 1:
        raise ValueError(f"batch {batch} and rounds {rounds} must be >= 1")
    dev = resolve_device(device)
    var_cfg, vae_cfg = var.cfg, vae.cfg
    kw = dict(cfg_scale=cfg_scale, top_k=top_k, top_p=top_p, dtype=dtype, device=dev)

    def make(rounds: int):
        if rounds == 1:
            plain = make_sampler(var_cfg, vae_cfg, **kw)
            return lambda gen, labels: plain(var, vae, gen, labels).image
        scan = make_scan_sampler(var_cfg, vae_cfg, rounds, **kw)
        return lambda gen, labels: scan(var, vae, gen, labels.reshape(rounds, batch)).image \
            .flatten(0, 1)

    sampler = make(rounds)
    chunk = rounds * batch
    total = len(labels_all)
    i = rng_i = 0
    while i < total:
        batch_labels = labels_all[i: i + chunk]
        if rounds > 1 and len(batch_labels) < chunk:
            # ragged tail under dispatch batching: per-batch decodes for the
            # remainder, as the JAX package avoids a short-shape scan compile
            sampler, chunk, rounds = make(1), batch, 1
            continue
        n = len(batch_labels)
        rng_i += 1
        if done is not None and done(i, n):
            i += n
            continue
        gen = torch.Generator(device=dev).manual_seed(seed + rng_i)
        img = sampler(gen, torch.as_tensor(batch_labels, dtype=torch.int64, device=dev))
        yield i, np.clip(img.cpu().numpy() * 255, 0, 255).astype(np.uint8)
        i += n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--vae_ckpt", default="vae_ch160v4096z32.pth")
    p.add_argument("--var_ckpt", default="")
    p.add_argument("--pn", default="1_2_3_4_5_6_8_10_13_16")
    p.add_argument("--out_dir", default="fid_samples")
    p.add_argument("--per_class", type=int, default=50)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--cfg", type=float, default=1.5)
    p.add_argument("--top_k", type=int, default=900)
    p.add_argument("--top_p", type=float, default=0.96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=1,
                   help="decode batches per chunk (make_scan_sampler); resume "
                        "granularity becomes rounds*batch")
    p.add_argument("--pack", action="store_true", help="pack npz when done")
    # tokenizer geometry overrides: small-scale protocol dry runs only; FID
    # numbers are meaningful with the published geometry (the defaults)
    p.add_argument("--V", type=int, default=4096)
    p.add_argument("--Cvae", type=int, default=32)
    p.add_argument("--ch", type=int, default=160)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from PIL import Image

    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.models import build_vae_var
    from var_tpu_torch.utils.logging import create_npz_from_sample_folder

    dev = resolve_device(args.device)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    _, _, vae, var = build_vae_var(
        device=dev, patch_nums=parse_patch_nums(args.pn), depth=args.depth,
        num_classes=args.num_classes, V=args.V, Cvae=args.Cvae, ch=args.ch,
        vae_ckpt=args.vae_ckpt if os.path.exists(args.vae_ckpt) else None,
        var_ckpt=args.var_ckpt if os.path.exists(args.var_ckpt) else None, dtype=dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    total = args.num_classes * args.per_class
    chunk = args.rounds * args.batch
    if total % chunk:
        print(f"note: {total} images not divisible by rounds*batch {chunk}; the final chunk "
              "is short")
    fname = lambda j: os.path.join(args.out_dir, f"{j:06d}.png")  # noqa: E731
    labels_all = np.repeat(np.arange(args.num_classes), args.per_class)
    for i, imgs in decode_chunks(
            var, vae, labels_all, args.batch, args.rounds, args.seed, args.cfg, args.top_k,
            args.top_p, dtype, dev,
            done=lambda i, n: all(os.path.exists(fname(j)) for j in range(i, i + n))):
        for j, img in enumerate(imgs):
            Image.fromarray(img).save(fname(i + j))
        if ((i + len(imgs)) // chunk) % 20 == 0:
            print(f"{i + len(imgs)}/{total} images")
    if args.pack:
        create_npz_from_sample_folder(args.out_dir, total)


if __name__ == "__main__":
    main()
