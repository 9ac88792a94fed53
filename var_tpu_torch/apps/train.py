"""VAR training CLI on one device (counterpart of the repository's ``train.py``):

    python -m var_tpu_torch.apps.train --local_debug=1 --device cpu

Flags are the reference recipes' (``config.TrainArgs``), plus ``--device``
(default ``cuda``; without a GPU the default raises, ``--device cpu`` runs
the plain PyTorch path). ``--local_debug=1`` is the two-step smoke on
seeded random images at a tiny configuration, with a checkpoint round trip
after the steps (reference ``train.py:140-162``). Training on ImageNet
needs the data loader, which is not ported yet: without ``--local_debug``
the CLI raises. Log lines are printed (the tensorboard logger is not ported
yet).
"""

from __future__ import annotations

import os
import time

import torch

from var_tpu_torch.config import VAEConfig, VARConfig, parse_cli
from var_tpu_torch.device import resolve_device
from var_tpu_torch.engine import checkpoint as ckpt
from var_tpu_torch.engine import trainer as tr
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod


def prog_si_at(args, g_it: int, max_it: float, wp_it: float) -> int:
    """Progressive-training stage of iteration ``g_it`` (-1: the whole pyramid)."""
    last = len(args.patch_nums) - 1
    if not args.pg:
        return -1
    if g_it <= wp_it:
        si = args.pg0
    elif g_it >= max_it * args.pg:
        si = last
    else:
        progress = min(max((g_it - wp_it) / (max_it * args.pg - wp_it), 0), 1)
        si = args.pg0 + round(progress * (last - args.pg0))
    return -1 if si == last else si


def step_generator(dev, seed: int, g_it: int) -> torch.Generator:
    """Per-step random stream keyed by (seed, g_it): a resumed run draws the
    cond-drop and drop-path masks the uninterrupted run would have drawn."""
    return torch.Generator(device=dev).manual_seed((seed << 32) + g_it)


def main(argv=None) -> None:
    args = parse_cli(argv).finalize(world_size=1)
    dev = resolve_device(args.device)
    if not args.local_debug:
        raise NotImplementedError(
            "training on ImageNet needs the data loader, which the port does not have yet "
            "(ROADMAP Queue A 16, the data slice); run --local_debug=1")
    if args.dbg_nan:  # the reference's anomaly detection (train.py:173-174)
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(args.local_out_dir_path, exist_ok=True)
    seed = args.seed or 0

    # local_debug: tiny shapes, float32 (reference local_debug semantics)
    vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1),
                        v_patch_nums=args.patch_nums)
    var_cfg = VARConfig(num_classes=10, depth=2, embed_dim=64, num_heads=4,
                        patch_nums=args.patch_nums, vocab_size=64, z_channels=8,
                        attn_l2_norm=args.anorm, shared_aln=args.saln)
    dtype = torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    vae = vae_mod.init_vae_params(vae_mod.VQVAE(vae_cfg).to(dev), gen)
    vae.eval().requires_grad_(False)
    var = var_mod.init_var_params(var_mod.VAR(var_cfg).to(dev), gen, init_std=args.ini,
                                  init_head=args.hd, init_adaln=args.aln,
                                  init_adaln_gamma=args.alng).train()
    n_params = sum(p.numel() for p in var.parameters())
    print(f"[train] device={dev} bs={args.bs} tlr={args.tlr:g} pn={args.patch_nums} "
          f"VAR params {n_params / 1e6:.2f}M", flush=True)

    iters_train = 2
    reso = args.patch_nums[-1] * vae_cfg.downsample
    data_gen = torch.Generator(device=dev).manual_seed(7)

    def next_batch():
        imgs = torch.rand(args.ac, args.batch_size, reso, reso, 3, generator=data_gen,
                          device=dev) * 2 - 1
        labels = torch.randint(0, var_cfg.num_classes, (args.ac, args.batch_size),
                               generator=data_gen, device=dev)
        return imgs, labels

    init_state, _ = tr.make_train_step(var_cfg, vae_cfg, args, iters_train, dtype=dtype)
    steps = {}

    def step_for(prog_si: int):
        if prog_si not in steps:
            steps[prog_si] = tr.make_train_step(var_cfg, vae_cfg, args, iters_train,
                                                prog_si=prog_si, dtype=dtype)[1]
        return steps[prog_si]

    state = init_state(var)
    max_it, wp_it = args.ep * iters_train, args.wp * iters_train
    prog_it, last_prog_si, first_prog = 0, -1, True
    ep = 0
    opt_steps = max(1, iters_train // args.ac)
    for opt_it in range(opt_steps):
        g_it = ep * iters_train + (opt_it + 1) * args.ac - 1
        t0 = time.perf_counter()
        imgs, labels = next_batch()
        prog_si = prog_si_at(args, g_it, max_it, wp_it)
        if last_prog_si != prog_si:
            if last_prog_si != -1:
                first_prog = False
            last_prog_si, prog_it = prog_si, 0
        prog_it += 1
        prog_wp = 1.0 if first_prog else max(min(prog_it / max(args.pgwp * iters_train, 1), 1),
                                              0.01)
        state, m = step_for(prog_si)(state, vae, imgs, labels,
                                     step_generator(dev, seed, g_it), g_it, prog_wp)
        print(f"[ep {ep}/{args.ep}] [{opt_it}/{opt_steps}] prog_si {prog_si} "
              f"loss {float(m.loss):.4f} Lm {float(m.Lm):.4f} Lt {float(m.Lt):.4f} "
              f"Accm {float(m.accm):.2f} tnm {float(m.grad_norm):.4f} tlr {m.lr:.3g} "
              f"wd {m.wd:.3g} step_t {time.perf_counter() - t0:.3f}s", flush=True)

    # checkpoint round trip (reference train.py:150-160)
    meta = dict(epoch=ep + 1, iter=0, args=args.state_dict())
    ckpt.save_checkpoint(args.last_ckpt_path, state, meta)
    fresh = init_state(var_mod.VAR(var_cfg).to(dev))
    fresh = ckpt.load_checkpoint(args.last_ckpt_path, fresh)
    for (name, a), b in zip(state.var.state_dict().items(), fresh.var.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"checkpoint round trip changed {name}")
    if fresh.step != state.step or ckpt.load_meta(args.last_ckpt_path)["epoch"] != ep + 1:
        raise RuntimeError("checkpoint round trip lost the step count or the meta")
    print(f"[local_debug] checkpoint round trip OK ({args.last_ckpt_path})", flush=True)
    print("[local_debug] smoke finished OK", flush=True)


if __name__ == "__main__":
    main()
