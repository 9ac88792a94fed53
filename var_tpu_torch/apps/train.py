"""VAR training CLI (counterpart of the repository's ``train.py``), on one GPU
or data-parallel over several under torchrun:

    python -m var_tpu_torch.apps.train --data_path=/path/to/imagenet --depth=16 \\
        --bs=768 --ep=200 --fp16=1 --alng=1e-3 --wpe=0.1
    torchrun --nproc_per_node 8 -m var_tpu_torch.apps.train --data_path=... --bs=768

``--bs`` is the global batch; each of the dp ranks loads its contiguous
slice of every epoch and steps on bs / dp rows, the gradients averaged
over the ranks (``parallel/mesh.py``, JAX ``train.py:42-47``, ``:118-184``:
pure data parallelism, ``make_mesh()``). Eval splits the val set into
contiguous per-rank parts, every rank runs the same number of padded
batches and the sums are reduced over the ranks. Only rank 0 writes
checkpoints, ``log.txt``, tensorboard and the tee; every rank resumes from
the same file.

Flags are the reference recipes' (``config.TrainArgs``), plus ``--device``
(default ``cuda``; without a GPU the default raises, ``--device cpu`` runs
the plain PyTorch path) and ``--attn`` (``auto|xla|pallas|hybrid|paired``;
``auto`` is ``paired`` on the GPU and ``xla`` on the CPU, as ``train.py``
resolves it). The eval step's attention is ``trainer.pick_eval_attn`` of
the training impl: the streaming kernel for a ``paired`` run at 512px and
1024px. On one GPU the training step (one per progressive stage) and the
eval step are CUDA graphs (``engine/compiled.py``) in one memory pool: the
first step captures after its eager run, later steps replay; a resumed run
loads its checkpoint before the first step, so the capture sees the
restored state. Under
torchrun (a process group) they run eagerly.

``--data_path`` holds ``train/`` and ``val/`` folders of class
subdirectories. The frozen tokenizer is the ``.pth`` that
``VAR_TPU_VAE_CKPT`` names (default ``vae_ch160v4096z32.pth``); without it
the CLI stops, unless ``--allow_random_vae=1``. The run resumes from the
newest ``ar-ckpt*`` file in ``--local_out_dir_path`` at its (epoch,
iteration), checkpoints every ``--ckpt_iters`` optimizer steps and at every
eval, evaluates every ``--val_freq_ep`` epochs and at the last one, and
appends one line per epoch to ``log.txt``; stdout and stderr are teed to
that folder, scalars go to tensorboard when tensorboardX is installed.
:func:`train` is the epoch loop alone, over any iterator of numpy batches.

``--local_debug=1`` is the two-step smoke on seeded random images at a tiny
configuration, with an eval of the last batch and a checkpoint round trip
after the steps (reference ``train.py:140-162``).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from var_tpu_torch.config import TrainArgs, VAEConfig, VARConfig, parse_cli, resolve_attn
from var_tpu_torch.device import resolve_device
from var_tpu_torch.engine import checkpoint as ckpt
from var_tpu_torch.engine import trainer as tr
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod
from var_tpu_torch.parallel import mesh as pm
from var_tpu_torch.utils.logging import (MetricLogger, ProfilerHooks, TensorboardLogger,
                                         dump_log_line, log, tee_output)

DEFAULT_VAE_CKPT = "vae_ch160v4096z32.pth"


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
    cond-drop and drop-path masks the uninterrupted run would have drawn,
    and every rank the same stream (the masks are drawn for the global
    batch, ``models/var.py::cond_drop``), so the draws do not depend on dp."""
    return torch.Generator(device=dev).manual_seed((seed << 32) + g_it)


def stack_to_device(arrays, dev: torch.device) -> torch.Tensor:
    """``np.stack(arrays)`` on ``dev``. On the GPU the arrays are copied once,
    into pinned host memory, which goes to the card without blocking."""
    if dev.type != "cuda":
        return torch.from_numpy(np.stack(arrays))
    first = torch.from_numpy(arrays[0])
    host = torch.empty((len(arrays), *first.shape), dtype=first.dtype, pin_memory=True)
    for row, a in zip(host, arrays):
        row.copy_(torch.from_numpy(a))
    return host.to(dev, non_blocking=True)


def build_models(args: TrainArgs, dev: torch.device):
    """The frozen tokenizer (``VAR_TPU_VAE_CKPT``, or seeded random weights
    with ``--allow_random_vae=1``) and the float32 VAR to train, from seeded
    weights (``train.py:79-102``). Returns (vae, var)."""
    from var_tpu_torch.models import build_vae_var_train

    vae_ckpt = os.environ.get("VAR_TPU_VAE_CKPT", DEFAULT_VAE_CKPT)
    if not os.path.exists(vae_ckpt):
        if not args.allow_random_vae:
            raise SystemExit(
                f"VAE checkpoint {vae_ckpt!r} not found. Training against a "
                f"random tokenizer silently produces meaningless targets "
                f"(the reference auto-downloads it, train.py:93-98). Point "
                f"VAR_TPU_VAE_CKPT at the converted vae_ch160v4096z32.pth, "
                f"or pass --allow_random_vae=1 to proceed anyway.")
        log(f"WARNING: VAE checkpoint {vae_ckpt} not found; proceeding "
            f"with a RANDOM tokenizer (--allow_random_vae=1: training "
            f"targets are meaningless noise)", force=True)
        vae_ckpt = None
    _, _, vae, var = build_vae_var_train(
        device=dev, seed=args.seed or 0, patch_nums=args.patch_nums, depth=args.depth,
        shared_aln=args.saln, attn_l2_norm=args.anorm, init_adaln=args.aln,
        init_adaln_gamma=args.alng, init_head=args.hd, init_std=args.ini, vae_ckpt=vae_ckpt)
    if vae_ckpt:
        log(f"loaded frozen VAE tokenizer from {vae_ckpt}")
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    log(f"VAR params: {count(var) / 1e6:.2f}M, VAE params: {count(vae) / 1e6:.2f}M")
    return vae, var


def resume_point(args: TrainArgs) -> Tuple[Optional[str], int, int, float]:
    """(newest checkpoint or None, start_ep, start_it, best_val_lt): read
    before the data, since the sampler resumes at (start_ep, start_it)
    (``train.py:104-114``)."""
    path, meta = ckpt.auto_resume(args.local_out_dir_path)
    if not path:
        return None, 0, 0, 1e9
    start_ep, start_it = int(meta.get("epoch", 0)), int(meta.get("iter", 0))
    log(f"auto-resuming from {path} at ep{start_ep} it{start_it}")
    return path, start_ep, start_it, float(meta.get("best_val_lt", 1e9))


def make_loaders(args: TrainArgs, train_ds, val_ds, start_ep: int, start_it: int,
                 train_tf: Callable, val_tf: Callable, batch_tf: Optional[Callable] = None,
                 world_size: int = 1, rank: int = 0):
    """(train iterator, iterations per epoch, val-batch factory) of data rank
    ``rank`` of ``world_size`` over two datasets (``train.py:118-184``): the
    resumable shuffled sampler's contiguous rank slice of each epoch, with
    per-sample streams keyed by (seed, epoch, index), and the rank's part of
    the contiguous no-pad val split in batches of ``batch_size``. Every
    rank's val factory yields the same number of items, None past its part
    (``train.py:346-349``)."""
    from var_tpu_torch.data.imagenet import DataLoader, DistInfiniteBatchSampler, eval_split_indices

    seed = args.seed or 0
    threads = args.workers or 16
    sampler = DistInfiniteBatchSampler(
        world_size=world_size, rank=rank, dataset_len=len(train_ds),
        glb_batch_size=args.batch_size * world_size, fill_last=True, shuffle=True,
        same_seed_for_all_ranks=seed, start_ep=start_ep, start_it=start_it)
    train_iter = iter(DataLoader(train_ds, sampler, train_tf, num_threads=threads, seed=seed,
                                 batch_transform=batch_tf))
    vbs = max(1, args.batch_size)
    nb = -(-(-(-len(val_ds) // world_size)) // vbs)  # identical on every rank

    def val_batches() -> Iterator:
        idxs = list(eval_split_indices(len(val_ds), world_size, rank))
        batches = [idxs[i:i + vbs] for i in range(0, len(idxs), vbs)]
        yield from DataLoader(val_ds, iter(batches), val_tf, num_threads=threads)
        for _ in range(nb - len(batches)):
            yield None

    return train_iter, len(sampler), val_batches


def train(args: TrainArgs, dev: torch.device, attn: str, vae: vae_mod.VQVAE,
          var: var_mod.VAR, train_iter: Iterator, iters_train: int,
          val_batches: Callable[[], Iterator], resume_path: Optional[str] = None,
          start_ep: int = 0, start_it: int = 0, best_val_lt: float = 1e9,
          mesh: Optional[pm.Mesh] = None):
    """The epoch loop of ``train.py:186-395``: steps over ``train_iter``'s
    (imgs (B, H, W, 3) float32, labels (B,) int) numpy batches, meters and
    tensorboard scalars, the mid-epoch checkpoint every ``ckpt_iters`` steps,
    eval over ``val_batches()`` (batches padded to ``batch_size`` rows with
    a valid mask; None: a batch of padding), the ``last`` and ``-best``
    checkpoints and ``log.txt``. ``var`` is restored from ``resume_path``
    when given. ``mesh``: the batches are this data rank's; the step
    averages the gradients and the eval sums over the ranks, and only rank
    0 writes (a barrier follows each save).

    Returns (TrainState, times): per step ``step_t`` and ``data_t`` (host
    seconds; a step ends when its metrics reach the host), per eval
    ``eval_s`` (seconds, batches) and ``val`` (vL_mean, vL_tail,
    vacc_mean, vacc_tail, n), per checkpoint ``save_s`` (rank 0)."""
    var_cfg, vae_cfg = var.cfg, vae.cfg
    dtype = torch.bfloat16 if args.fp16 else torch.float32
    seed = args.seed or 0
    init_state, _ = tr.make_train_step(var_cfg, vae_cfg, args, iters_train, dtype=dtype,
                                       attn_impl=attn, mesh=mesh)
    steps = {}
    # one memory pool for the steps' and the eval's first calls and graphs,
    # which run one after another: their activations and cuDNN workspaces
    # share memory
    pool = torch.cuda.MemPool() if dev.type == "cuda" else None

    def step_for(prog_si: int):
        """The compiled step of a progressive stage (one CUDA graph each, as
        JAX compiles one program each). Stages only advance, so an earlier
        stage's graph is dropped; its temporaries stay in the pool that the
        steps and the eval share, for the next stage's capture."""
        if prog_si not in steps:
            steps.clear()
            steps[prog_si] = tr.make_train_step(var_cfg, vae_cfg, args, iters_train,
                                                prog_si=prog_si, dtype=dtype, attn_impl=attn,
                                                mesh=mesh, pool=pool)[1]
        return steps[prog_si]

    eval_step = tr.make_eval_step(var_cfg, vae_cfg, dtype=dtype,
                                  attn_impl=tr.pick_eval_attn(attn, var_cfg.seq_len), mesh=mesh,
                                  pool=pool)
    state = init_state(var)
    if resume_path:
        state = ckpt.load_checkpoint(resume_path, state)
        log(f"restored checkpoint state from {resume_path}")

    times = {"step_t": [], "data_t": [], "eval_s": [], "val": [], "save_s": []}

    def save(path: str, meta: dict) -> None:
        if pm.process_is_master():
            t0 = time.perf_counter()
            ckpt.save_checkpoint(path, state, meta)
            times["save_s"].append(time.perf_counter() - t0)
        pm.barrier()

    tb = TensorboardLogger(args.tb_log_dir_path)
    profiler = ProfilerHooks()  # active only with VAR_TPU_PROFILE_DIR set
    max_it, wp_it = args.ep * iters_train, args.wp * iters_train
    prog_it, last_prog_si, first_prog = 0, -1, True
    for ep in range(start_ep, args.ep):
        me = MetricLogger()
        ep_start = time.time()
        opt_steps_per_ep = max(1, iters_train // args.ac)
        it0 = start_it // args.ac if ep == start_ep else 0
        for opt_it in range(it0, opt_steps_per_ep):
            g_it = ep * iters_train + (opt_it + 1) * args.ac - 1
            t_data = time.time()
            micro = [next(train_iter) for _ in range(args.ac)]
            imgs = stack_to_device([b[0] for b in micro], dev)
            labels = stack_to_device([b[1] for b in micro], dev).long()
            data_t = time.time() - t_data

            prog_si = prog_si_at(args, g_it, max_it, wp_it)
            if last_prog_si != prog_si:
                if last_prog_si != -1:
                    first_prog = False
                last_prog_si, prog_it = prog_si, 0
            prog_it += 1
            prog_wp = max(min(prog_it / max(args.pgwp * iters_train, 1), 1), 0.01)
            if first_prog:
                prog_wp = 1.0

            profiler.maybe_toggle(opt_it)
            state, m = step_for(prog_si)(state, vae, imgs, labels,
                                         step_generator(dev, seed, g_it), g_it, prog_wp)
            # one device-to-host read of the step's scalars, as train.py reads
            # them every step (:302-305)
            lm, lt, accm, acct, tnm = torch.stack(
                [m.Lm, m.Lt, m.accm, m.acct, m.grad_norm]).tolist()
            step_t = time.time() - t_data
            me.update(Lm=lm, Lt=lt, Accm=accm, Acct=acct, tnm=tnm, tlr=m.lr, data_t=data_t,
                      step_t=step_t)
            times["step_t"].append(step_t)
            times["data_t"].append(data_t)
            if opt_it % 50 == 0 or opt_it == opt_steps_per_ep - 1:
                eta = me.eta("step_t", opt_steps_per_ep - opt_it - 1)
                log(f"[ep {ep}/{args.ep}] [{opt_it}/{opt_steps_per_ep}] {me} {eta}")
                tb.set_step(g_it)
                tb.update(head="AR_iter_loss", Lm=lm, Lt=lt, Accm=accm, Acct=acct)
                tb.update(head="AR_opt_lr/lr_max", sche_tlr=m.lr)
                tb.update(head="AR_opt_wd/wd_max", sche_twd=m.wd)
                tb.update(head="AR_opt_grad/grad", grad_norm=tnm, grad_clip=args.tclip)
            if g_it == 0 or (g_it + 1) % 500 == 0:
                hist = m.pred_hist.cpu().numpy()
                usage = float((hist / max(hist.sum(), 1) > 0.001 / var_cfg.vocab_size).mean() * 100)
                per = {f"acc_{args.resos[si]}": float(a)
                       for si, a in enumerate(m.per_scale_acc.tolist()) if np.isfinite(a)}
                per.update({f"L_{args.resos[si]}": float(v)
                            for si, v in enumerate(m.per_scale_L.tolist()) if np.isfinite(v)})
                tb.update(head="AR_iter_loss", z_voc_usage=usage, step=g_it, **per)
            if args.ckpt_iters and (opt_it + 1) % args.ckpt_iters == 0 \
                    and (opt_it + 1) < opt_steps_per_ep:
                # mid-epoch checkpoint with the TRUE iteration, so a resumed
                # run replays the uninterrupted batch sequence
                save(args.last_ckpt_path, dict(epoch=ep, iter=(opt_it + 1) * args.ac,
                                               best_val_lt=best_val_lt, args=args.state_dict()))
                log(f"[ep {ep} it {(opt_it + 1) * args.ac}] mid-epoch checkpoint saved")

        # ---- eval + checkpoint every val_freq_ep epochs and at the end
        if (ep + 1) % args.val_freq_ep == 0 or (ep + 1) == args.ep:
            # the contiguous no-pad split, padded to fixed-size batches with a
            # valid mask (train.py:330-376)
            t_eval = time.perf_counter()
            vbs = max(1, args.batch_size)
            nb = 0
            stats = torch.zeros(5, dtype=torch.float64, device=dev)
            reso = args.patch_nums[-1] * vae_cfg.downsample
            for batch in val_batches():
                vimgs, vlabels = batch if batch is not None else (
                    np.zeros((0, reso, reso, 3), np.float32), np.zeros((0,), np.int32))
                n_local = vimgs.shape[0]
                valid = np.zeros((vbs,), np.float32)
                valid[:n_local] = 1.0
                if n_local < vbs:
                    pad = vbs - n_local
                    vimgs = np.concatenate([vimgs, np.zeros((pad,) + vimgs.shape[1:], np.float32)])
                    vlabels = np.concatenate([vlabels, np.zeros((pad,), np.int32)])
                stats += eval_step(state.var, vae, stack_to_device([vimgs], dev)[0],
                                   stack_to_device([vlabels], dev)[0].long(),
                                   stack_to_device([valid], dev)[0]).double()
                nb += 1
            stats = stats.cpu().numpy()
            times["eval_s"].append((time.perf_counter() - t_eval, nb))
            tot = stats[-1]
            vL_mean, vL_tail, vacc_mean, vacc_tail = (stats[:4] / max(tot, 1)).tolist()
            times["val"].append((vL_mean, vL_tail, vacc_mean, vacc_tail, int(tot)))
            log(f"[ep {ep}] val: L_mean {vL_mean:.4f} L_tail {vL_tail:.4f} "
                f"acc_mean {vacc_mean:.2f} acc_tail {vacc_tail:.2f} (n={int(tot)})")
            tb.update(head="AR_ep_loss", step=ep, vL_mean=vL_mean, vL_tail=vL_tail,
                      vacc_mean=vacc_mean, vacc_tail=vacc_tail)
            meta = dict(epoch=ep + 1, iter=0, best_val_lt=min(best_val_lt, vL_tail),
                        args=args.state_dict())
            save(args.last_ckpt_path, meta)
            if vL_tail < best_val_lt:
                # the same state and meta as `last`: auto_resume may pick either
                best_val_lt = vL_tail
                save(args.last_ckpt_path + "-best", meta)
            log(f"[ep {ep}] checkpoint saved to {args.last_ckpt_path}")

        dump_log_line(args, _first=(ep == start_ep), ep=f"{ep + 1}/{args.ep}",
                      L_mean=me.meters["Lm"].global_avg,
                      acc_mean=me.meters["Accm"].global_avg,
                      lr=me.meters["tlr"].value,
                      ep_time=round(time.time() - ep_start, 1))
        gc.collect()

    tb.close()
    log("training done")
    return state, times


def train_imagenet(args: TrainArgs, dev: torch.device, attn: str,
                   mesh: Optional[pm.Mesh] = None) -> None:
    """The ImageNet-folder flow of ``train.py``, in its order: tokenizer and
    VAR, resume point, datasets and loaders, then :func:`train`."""
    from var_tpu_torch.data import native_loader
    from var_tpu_torch.data.imagenet import FolderDataset, make_transform

    dp, rank = (1, 0) if mesh is None else (mesh.dp, mesh.data_rank)
    log(f"devices={dp} ({dev.type}), args bs={args.bs} batch/dev={args.batch_size} "
        f"tlr={args.tlr:g} pn={args.patch_nums} attn={attn}")
    vae, var = build_models(args, dev)
    resume_path, start_ep, start_it, best_val_lt = resume_point(args)
    train_ds = FolderDataset(os.path.join(args.data_path, "train"))
    val_ds = FolderDataset(os.path.join(args.data_path, "val"))
    log(f"dataset: {len(train_ds)} train, {len(val_ds)} val images")
    batch_tf = None
    if native_loader.available():
        batch_tf = native_loader.make_native_batch_transform(
            args.data_load_reso, args.mid_reso, train=True, hflip=args.hflip,
            num_threads=args.workers or 16)
        log("using native C++ image pipeline")
    train_iter, iters_train, val_batches = make_loaders(
        args, train_ds, val_ds, start_ep, start_it,
        make_transform(args.data_load_reso, args.mid_reso, train=True, hflip=args.hflip),
        make_transform(args.data_load_reso, args.mid_reso, train=False), batch_tf, dp, rank)
    train(args, dev, attn, vae, var, train_iter, iters_train, val_batches, resume_path,
          start_ep, start_it, best_val_lt, mesh)


def local_debug(args: TrainArgs, dev: torch.device, attn: str,
                mesh: Optional[pm.Mesh] = None) -> None:
    """Two steps on seeded random images at a tiny configuration, float32,
    an eval of the last batch, then a checkpoint round trip (rank 0).
    ``mesh``: each data rank steps on its rows of the seeded global batch."""
    seed = args.seed or 0
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
    eval_attn = tr.pick_eval_attn(attn, var_cfg.seq_len)
    log(f"[train] device={dev} bs={args.bs} tlr={args.tlr:g} pn={args.patch_nums} "
        f"attn={attn} eval_attn={eval_attn} VAR params {n_params / 1e6:.2f}M")

    iters_train = 2
    reso = args.patch_nums[-1] * vae_cfg.downsample
    data_gen = torch.Generator(device=dev).manual_seed(7)
    row0, glb = pm.data_rows(mesh, args.batch_size)

    def next_batch():
        imgs = torch.rand(args.ac, glb, reso, reso, 3, generator=data_gen, device=dev) * 2 - 1
        labels = torch.randint(0, var_cfg.num_classes, (args.ac, glb), generator=data_gen,
                               device=dev)
        return imgs[:, row0:row0 + args.batch_size], labels[:, row0:row0 + args.batch_size]

    init_state, _ = tr.make_train_step(var_cfg, vae_cfg, args, iters_train, dtype=dtype,
                                       attn_impl=attn, mesh=mesh)
    steps = {}
    # one memory pool for the steps' and the eval's first calls and graphs,
    # which run one after another: their activations and cuDNN workspaces
    # share memory
    pool = torch.cuda.MemPool() if dev.type == "cuda" else None

    def step_for(prog_si: int):
        """The compiled step of a progressive stage (one CUDA graph each, as
        JAX compiles one program each). Stages only advance, so an earlier
        stage's graph is dropped; its temporaries stay in the pool that the
        steps and the eval share, for the next stage's capture."""
        if prog_si not in steps:
            steps.clear()
            steps[prog_si] = tr.make_train_step(var_cfg, vae_cfg, args, iters_train,
                                                prog_si=prog_si, dtype=dtype, attn_impl=attn,
                                                mesh=mesh, pool=pool)[1]
        return steps[prog_si]

    eval_step = tr.make_eval_step(var_cfg, vae_cfg, dtype=dtype, attn_impl=eval_attn, mesh=mesh,
                                  pool=pool)

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
        log(f"[ep {ep}/{args.ep}] [{opt_it}/{opt_steps}] prog_si {prog_si} "
            f"loss {float(m.loss):.4f} Lm {float(m.Lm):.4f} Lt {float(m.Lt):.4f} "
            f"Accm {float(m.accm):.2f} tnm {float(m.grad_norm):.4f} tlr {m.lr:.3g} "
            f"wd {m.wd:.3g} step_t {time.perf_counter() - t0:.3f}s")

    # local_debug has no val split (the JAX trainer runs no eval there,
    # train.py:331): the eval step runs once on the last smoke batch
    sums = eval_step(state.var, vae, imgs[0], labels[0], torch.ones(args.batch_size, device=dev))
    log(f"[local_debug] eval ({eval_attn}) L_mean {float(sums[0] / sums[4]):.4f} "
        f"acc_mean {float(sums[2] / sums[4]):.2f}")
    if not pm.process_is_master():
        return

    # checkpoint round trip (reference train.py:150-160)
    init_state, _ = tr.make_train_step(var_cfg, vae_cfg, args, iters_train, dtype=dtype,
                                       attn_impl=attn)
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


def main(argv=None) -> None:
    """The CLI: under torchrun (``WORLD_SIZE`` set) every process joins the
    group (nccl, or gloo with ``--device cpu``) and the mesh is pure data
    parallelism over all of them."""
    args = parse_cli(argv)
    joined = not torch.distributed.is_initialized()
    pm.initialize_distributed("gloo" if args.device == "cpu" else None)
    mesh = pm.make_mesh()
    args = args.finalize(world_size=mesh.dp)
    dev = resolve_device(args.device)
    attn = resolve_attn(args.attn, dev)
    if args.dbg_nan:  # the reference's anomaly detection (train.py:173-174)
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(args.local_out_dir_path, exist_ok=True)
    untee = (tee_output(args.local_out_dir_path) if pm.process_is_master()
             and not args.local_debug else (lambda: None))
    try:
        if args.local_debug:
            local_debug(args, dev, attn, mesh)
        else:
            train_imagenet(args, dev, attn, mesh)
    finally:
        untee()
        if joined and torch.distributed.is_initialized():  # the group this call joined
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
