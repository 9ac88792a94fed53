"""Full train -> sample -> score quality loop on a held-out split
(counterpart of ``scripts/quality_loop.py``)::

    python -m var_tpu_torch.apps.quality_loop --out_dir qloop/ [--device cpu]

At a small configurable scale, end to end:

1. a labeled image dataset of per-class oriented colour gratings (a model
   must learn class conditioning), in ImageNet folder layout with a
   held-out ``val/`` split (:func:`gen_dataset`, JPEGs through Pillow, the
   JAX script's bytes);
2. a VQVAE tokenizer trained on the train split
   (``engine/vae_trainer.py``, lr 3e-4);
3. a VAR trained on the frozen tokenizer through the data pipeline
   (``FolderDataset`` -> ``DistInfiniteBatchSampler`` -> threaded
   ``DataLoader``) with ``engine/trainer.py::make_train_step`` in float32,
   each step's stream keyed by (seed, g_it), and a masked fixed-shape val
   eval (``make_eval_step``) after every epoch: val loss on held-out data;
4. class-conditional samples (top_k 32, top_p 0.95) from the initial and
   the trained parameters;
5. both sample sets scored against the train split with
   ``metrics/fid.py``'s vae extractor on the trained tokenizer: the FID
   proxy should improve with training.

Prints one JSON line: ``vae_recon_first_last``, ``val_curve``,
``val_improved``, ``fid_init``, ``fid_trained``, ``fid_improved``.

The training attention resolves as ``--attn auto`` does
(``config.resolve_attn``): the paired training kernel (row 6) on the GPU,
the dense path on the CPU; the eval attention is ``pick_eval_attn``'s.
``--device`` defaults to ``cuda``. :func:`run` takes the datasets as
objects (``samples`` of (item, label) and a transform ``tf(item, rng)``), so
a caller can feed :func:`grating_images`' arrays without image files.
Reference anchors: val loop ``trainer.py:54-84`` / ``train.py:208-231``;
FID protocol ``README.md:151-157``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

TOP_K, TOP_P = 32, 0.95  # the sampling filter of the JAX script's step 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="quality_loop_out")
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--per_class", type=int, default=64)
    p.add_argument("--val_per_class", type=int, default=16)
    p.add_argument("--pn", default="1_2_3_4_6_8")
    p.add_argument("--vae_steps", type=int, default=300)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--sample_per_class", type=int, default=8)
    p.add_argument("--cfg", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json_out", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def vae_config(args):
    """The loop's tokenizer: downsample 8 (4 ch_mult levels), so the images
    are 8 * pns[-1] pixels a side."""
    from var_tpu_torch.config import VAEConfig, parse_patch_nums

    return VAEConfig(vocab_size=args.vocab, z_channels=16, ch=32, ch_mult=(1, 1, 2, 2),
                     v_patch_nums=parse_patch_nums(args.pn))


# ---------------------------------------------------------------------------
# the grating dataset


def grating_images(classes: int, per_class: int, val_per_class: int, reso: int,
                   seed: int) -> Iterator[Tuple[str, int, int, np.ndarray]]:
    """(split, class, index, (reso, reso, 3) uint8) in the JAX script's order
    and numpy stream: class k is a sinusoidal grating at angle k*pi/classes
    in a class-specific hue, with per-sample phase/frequency jitter and
    pixel noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:reso, 0:reso].astype(np.float32) / reso
    for split, n in (("train", per_class), ("val", val_per_class)):
        for c in range(classes):
            ang = np.pi * c / classes
            hue = np.array([np.sin(2.3 * c) * 0.5 + 0.5,
                            np.sin(1.7 * c + 2) * 0.5 + 0.5,
                            np.sin(3.1 * c + 4) * 0.5 + 0.5], np.float32)
            for i in range(n):
                freq = 4.0 + rng.uniform(-0.5, 0.5)
                phase = rng.uniform(0, 2 * np.pi)
                wave = np.sin(2 * np.pi * freq *
                              (np.cos(ang) * xx + np.sin(ang) * yy) + phase)
                img = 0.5 + 0.45 * wave[..., None] * (hue * 2 - 1)
                img = img + rng.normal(0, 0.03, img.shape)
                yield split, c, i, np.clip(img * 255, 0, 255).astype(np.uint8)


def gen_dataset(root: str, classes: int, per_class: int, val_per_class: int,
                reso: int, seed: int) -> None:
    """Write the gratings as ``{split}/class_{c:03d}/{i:05d}.jpg`` (quality
    92), the bytes of the JAX script's ``gen_dataset``.

    A ``dataset.json`` manifest pins the generation parameters: reuse is
    allowed only on an exact match, otherwise both splits are wiped and
    regenerated; a stale split from other parameters would silently
    mislabel the evidence (extra class dirs become labels >= num_classes)."""
    import shutil

    from PIL import Image

    manifest = {"classes": classes, "per_class": per_class,
                "val_per_class": val_per_class, "reso": reso, "seed": seed}
    mpath = os.path.join(root, "dataset.json")
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                if json.load(f) == manifest:
                    return  # same parameters: the dataset on disk is exact
        except (OSError, ValueError):
            pass
    # missing/mismatched manifest (also: interrupted generation) -> rebuild
    for split in ("train", "val"):
        shutil.rmtree(os.path.join(root, split), ignore_errors=True)
    for split, c, i, arr in grating_images(classes, per_class, val_per_class, reso, seed):
        d = os.path.join(root, split, f"class_{c:03d}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(arr).save(os.path.join(d, f"{i:05d}.jpg"), quality=92)
    with open(mpath, "w") as f:
        json.dump(manifest, f)


# ---------------------------------------------------------------------------
# the loop


def run(args, train_ds, val_ds, train_tf: Callable, eval_tf: Callable,
        log: Callable = print) -> Tuple[dict, Dict[str, np.ndarray], dict]:
    """The quality loop on ``args.device`` over two datasets (``samples`` of
    (item, label); ``tf(item, rng)`` -> (H, W, 3) float32 in [-1, 1]).
    Returns (the JSON line's dict, {"init" | "trained": (N, H, W, 3) uint8
    samples}, {"vae": the trained tokenizer, "init" | "trained": the VAR}),
    the modules frozen, in eval mode, on the device."""
    from var_tpu_torch.apps.train import step_generator
    from var_tpu_torch.config import TrainArgs, VARConfig, parse_patch_nums, resolve_attn
    from var_tpu_torch.data.imagenet import DataLoader, DistInfiniteBatchSampler
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.engine import vae_trainer as vtr
    from var_tpu_torch.engine.sampler import fold_in, make_sampler
    from var_tpu_torch.metrics import fid as F
    from var_tpu_torch.models import build_vae_train
    from var_tpu_torch.models import var as var_mod

    dev = resolve_device(args.device)
    pns = parse_patch_nums(args.pn)
    vae_cfg = vae_config(args)
    reso = pns[-1] * vae_cfg.downsample
    attn = resolve_attn("auto", dev)
    log(f"[quality_loop] {len(train_ds)} train / {len(val_ds)} val images, reso {reso}, "
        f"device {dev}, attn {attn}")
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # ---- 1) tokenizer training ----------------------------------------
    v_init, v_step = vtr.make_vae_train_step(vae_cfg, lr=3e-4)
    v_state = v_init(build_vae_train(device=dev, seed=args.seed, cfg=vae_cfg))
    # the whole train split in memory (tiny), eval transform
    rng_np = np.random.default_rng(args.seed)
    all_train = np.stack([eval_tf(item, rng_np) for item, _ in train_ds.samples])
    recon0 = recon = None
    for it in range(args.vae_steps):
        idx = rng_np.integers(0, len(all_train), size=min(args.bs, len(all_train)))
        v_state, vm = v_step(v_state, to_dev(all_train[idx]))
        if it == 0:
            recon0 = float(vm["recon"])
        if it % 100 == 0 or it == args.vae_steps - 1:
            recon = float(vm["recon"])
            log(f"[vae {it}/{args.vae_steps}] recon {recon:.5f} vq {float(vm['vq']):.5f}")
    usage = vtr.vocab_usage_percent(v_state, vae_cfg, 1, args.bs).cpu().numpy()
    log(f"[vae] recon {recon0:.5f} -> {recon:.5f}; usage% per scale "
        f"{usage.round(1).tolist()}")
    vae = v_state.vae.eval().requires_grad_(False)

    # ---- 2) VAR training through the data pipeline -----------------------
    var_cfg = VARConfig(num_classes=args.classes, depth=args.depth, embed_dim=args.width,
                        num_heads=args.heads, patch_nums=pns, vocab_size=args.vocab,
                        z_channels=16, attn_l2_norm=True)
    targs = TrainArgs(depth=args.depth, bs=args.bs, ac=1, ep=args.epochs,
                      pn=args.pn).finalize(world_size=1)
    iters_train = max(1, len(train_ds) // args.bs)
    init_state, step = tr.make_train_step(var_cfg, vae_cfg, targs, iters_train,
                                          dtype=torch.float32, attn_impl=attn)
    eval_step = tr.make_eval_step(var_cfg, vae_cfg, dtype=torch.float32,
                                  attn_impl=tr.pick_eval_attn(attn, var_cfg.seq_len))
    with torch.device("meta"):
        var = var_mod.VAR(var_cfg)
    var = var_mod.init_var_params(var.to_empty(device=dev),
                                  torch.Generator(device=dev).manual_seed(args.seed + 1))
    var0 = copy.deepcopy(var).eval().requires_grad_(False)
    state = init_state(var.train().requires_grad_(True))

    sampler_obj = DistInfiniteBatchSampler(
        world_size=1, rank=0, dataset_len=len(train_ds), glb_batch_size=args.bs,
        fill_last=True, shuffle=True, same_seed_for_all_ranks=args.seed)
    loader = iter(DataLoader(train_ds, sampler_obj, train_tf, num_threads=8, seed=args.seed))
    all_val = np.stack([eval_tf(item, rng_np) for item, _ in val_ds.samples])
    val_labels = np.asarray([lbl for _, lbl in val_ds.samples], np.int64)

    def val_loss(model) -> float:
        stats = np.zeros(5, np.float64)
        for i in range(0, len(all_val), args.bs):
            imgs, labs = all_val[i:i + args.bs], val_labels[i:i + args.bs]
            n = imgs.shape[0]
            if n < args.bs:  # fixed-shape masked pad (train.py:360-370)
                imgs = np.concatenate(
                    [imgs, np.zeros((args.bs - n,) + imgs.shape[1:], np.float32)])
                labs = np.concatenate([labs, np.zeros((args.bs - n,), np.int64)])
            valid = (np.arange(args.bs) < n).astype(np.float32)
            stats += eval_step(model, vae, to_dev(imgs), to_dev(labs),
                               to_dev(valid)).double().cpu().numpy()
        return float(stats[0] / max(stats[-1], 1))

    # AdamW updates the parameters in place: a sampler captured on the model
    # (make_sampler's CUDA graph) keeps reading them across training
    addresses = [t.data_ptr() for t in state.var.parameters()]
    val_curve = [val_loss(state.var)]
    log(f"[var ep -1] val L_mean {val_curve[0]:.4f} (untrained)")
    g_it = 0
    for ep in range(args.epochs):
        for _ in range(iters_train):
            imgs, labels = next(loader)
            state, m = step(state, vae, to_dev(imgs)[None], to_dev(labels.astype(np.int64))[None],
                            step_generator(dev, args.seed, g_it), g_it, 1.0)
            g_it += 1
        val_curve.append(val_loss(state.var))
        log(f"[var ep {ep}] train Lm {float(m.Lm):.4f} val L_mean {val_curve[-1]:.4f}")
    if [t.data_ptr() for t in state.var.parameters()] != addresses:
        raise RuntimeError("training moved the VAR's parameters to new addresses")
    trained = state.var.eval().requires_grad_(False)

    # ---- 3) sample from the initial and the trained parameters ----------
    sampler = make_sampler(var_cfg, vae_cfg, cfg_scale=args.cfg, top_k=TOP_K, top_p=TOP_P,
                           dtype=torch.float32, device=dev)
    labels_s = np.repeat(np.arange(args.classes), args.sample_per_class)

    def sample_set(model) -> np.ndarray:
        key = torch.Generator(device=dev).manual_seed(args.seed + 7)
        out = []
        for off in range(0, len(labels_s), args.bs):
            res = sampler(model, vae, fold_in(key, off), labels_s[off:off + args.bs])
            out.append(np.clip(res.image.cpu().numpy() * 255, 0, 255).astype(np.uint8))
        return np.concatenate(out)

    samples = {"init": sample_set(var0), "trained": sample_set(trained)}

    # ---- 4) FID proxy on the trained tokenizer's features --------------
    extractor = F.make_vae_extractor(vae=vae, device=dev)

    def stats(u8: np.ndarray):
        return F.feature_stats(np.concatenate([extractor(u8[i:i + 64])
                                               for i in range(0, len(u8), 64)]))

    mu_r, s_r = stats(np.clip((all_train + 1) * 127.5, 0, 255).astype(np.uint8))
    fids = {tag: F.frechet_distance(mu_r, s_r, *stats(u8)) for tag, u8 in samples.items()}
    result = {
        "metric": "quality_loop",
        "reso": reso,
        "train_images": len(train_ds),
        "val_images": len(val_ds),
        "vae_recon_first_last": [round(recon0, 5), round(recon, 5)],
        "val_curve": [round(v, 4) for v in val_curve],
        "val_improved": bool(val_curve[-1] < val_curve[0]),
        "fid_init": round(fids["init"], 3),
        "fid_trained": round(fids["trained"], 3),
        "fid_improved": bool(fids["trained"] < fids["init"]),
    }
    return result, samples, {"vae": vae, "init": var0, "trained": trained}


def main(argv=None):
    import shutil

    from PIL import Image

    args = build_parser().parse_args(argv)

    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.data.imagenet import FolderDataset, make_transform
    from var_tpu_torch.device import resolve_device

    resolve_device(args.device)
    reso = parse_patch_nums(args.pn)[-1] * vae_config(args).downsample
    gen_dataset(args.out_dir, args.classes, args.per_class, args.val_per_class, reso,
                args.seed)
    train_ds = FolderDataset(os.path.join(args.out_dir, "train"))
    val_ds = FolderDataset(os.path.join(args.out_dir, "val"),
                           class_to_idx=train_ds.class_to_idx)
    result, samples, _ = run(args, train_ds, val_ds, make_transform(reso, train=True, hflip=False),
                          make_transform(reso, train=False),
                          log=lambda s: print(s, flush=True))
    for tag, imgs in samples.items():
        d = os.path.join(args.out_dir, f"samples_{tag}")
        shutil.rmtree(d, ignore_errors=True)  # stale extras would mislead
        os.makedirs(d)
        for i, img in enumerate(imgs):
            Image.fromarray(img).save(os.path.join(d, f"{i:06d}.png"))
    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
