"""The training generator: the program's compiled training step
(``var_tpu_torch.engine.trainer.make_train_step``) in a closed loop over a
rotating pool of seeded batches.

A traffic file of kind ``train`` gives the recipe's flags (``fp16``,
``tclip``, ``remat``, ``attn``, ``ep``, ``wpe``, ``tblr``, ``global_bs``: the
batch of the whole job, of which a card takes ``batch``), ``pool`` (batches
made at set-up), ``start_epoch`` and ``iters_per_epoch`` (where in the
schedule the steps run: past the warm-up, at the peak learning rate),
``check_steps`` and ``trace_calls``.

Set-up makes one training state and drives it through the first
``check_steps`` steps with the window's own call, on distinct batches; the
window goes on with the same state. The steps' losses, the first step's
clipped gradient (Adam's first moment after one step, over 1 - beta1) and
the parameters' change after them are what the reference is held to.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.harness import check, weights
from benchmark.harness.sample import port_config
from benchmark.harness.trace import Profiled
from benchmark.reference import models as M
from benchmark.reference.train import Trainer

BETA1 = 0.9


def sub_seed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def pool(ctx, n: int):
    """``n`` global batches (every rank's rows) of (1, B, H, W, 3) images
    uniform in [-1, 1] and (1, B) labels, drawn on the device from the
    seed."""
    import torch

    t, s = ctx.traffic, ctx.sizes
    b = t["batch"] * ctx.world
    g = torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, 11))
    imgs = torch.rand(n, 1, b, s.reso, s.reso, 3, generator=g, device=ctx.device)
    labels = torch.randint(0, s.num_classes, (n, 1, b), generator=g, device=ctx.device)
    return imgs.mul_(2).sub_(1), labels


def leaf_stats(named) -> dict:
    """Per leaf, the float64 sum and norm of its values: the same on every
    rank when every rank holds the same parameters."""
    return {n: (float(p.detach().double().sum()), float(p.detach().double().norm()))
            for n, p in named}


def rank_spread(stats: list) -> float:
    """The widest relative gap between a rank's leaf statistics and rank
    0's."""
    worst = 0.0
    for other in stats[1:]:
        for n, (s0, n0) in stats[0].items():
            s1, n1 = other[n]
            worst = max(worst, abs(s1 - s0) / max(n0, 1e-30), abs(n1 - n0) / max(n0, 1e-30))
    return worst


def step_generator(ctx):
    import torch

    return torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, 12))


def peak_lr(t: dict) -> float:
    return t["tblr"] * t["global_bs"] / 256


def run(ctx) -> dict:
    import torch

    from var_tpu_torch.config import TrainArgs, resolve_attn
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import from_pretrained_dict

    from benchmark.harness.ranks import agree, gather

    t, s, dev = ctx.traffic, ctx.sizes, ctx.device
    b = t["batch"]
    rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
    ctx.phase("imports")
    sd = weights.make(s, ctx.seed, dev)
    vae_cfg, var_cfg, vae, var = from_pretrained_dict(port_config(ctx.config), sd, device=dev)
    var.train().requires_grad_(True)
    start = {n: sd[n] for n, _ in var.named_parameters()}
    del sd
    args = TrainArgs(depth=s.depth, bs=t["global_bs"], ep=t["ep"], fp16=t["fp16"],
                     tclip=t["tclip"], remat=t["remat"], wpe=t["wpe"], tblr=t["tblr"],
                     twd=t["twd"], attn=t["attn"]).finalize(world_size=1)
    init_state, step = tr.make_train_step(var_cfg, vae_cfg, args, t["iters_per_epoch"],
                                          dtype=getattr(torch, t["dtype"]),
                                          attn_impl=resolve_attn(args.attn, dev),
                                          mesh=ctx.mesh)
    state = init_state(var)
    imgs, labels = pool(ctx, t["pool"])
    imgs, labels = imgs[:, :, rows].contiguous(), labels[:, :, rows].contiguous()
    ctx.phase("weights, state and batches")
    gen = step_generator(ctx)
    it0 = t["start_epoch"] * t["iters_per_epoch"]
    named = list(var.named_parameters())
    got = {"losses": []}
    for i in range(t["check_steps"]):
        state, m = step(state, vae, imgs[i], labels[i], gen, it0 + i)
        got["losses"].append(float(m.loss))
        if i == 0:
            st = state.opt.opt.state
            got["grad_norms"] = {n: float(st[p]["exp_avg"].norm()) / (1 - BETA1)
                                 for n, p in named}
    got["changes"] = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    del start
    ctx.sync()
    ctx.phase("first steps (capture)")

    k, n_steps, norms, prof, prev = t["check_steps"], 0, [], None, None
    t_start = time.perf_counter()
    ctx.setup_s = t_start - ctx.t0

    def one(j):
        nonlocal state
        state, m = step(state, vae, imgs[j % t["pool"]], labels[j % t["pool"]], gen, it0 + j)
        norms.append(m.grad_norm)

    while True:
        if ctx.trace and prof is None:
            with Profiled(enabled=ctx.rank == 0) as prof:
                for j in range(t["trace_calls"]):
                    one(k + j)
                ctx.sync()
            k += t["trace_calls"]
            n_steps += t["trace_calls"]
        else:
            one(k)
            k += 1
            n_steps += 1
            ev = torch.cuda.Event() if ctx.cuda else None
            if ev is not None:
                ev.record()
            if prev is not None:
                prev.synchronize()  # one step in flight: the host never runs far ahead
            prev = ev
        if agree(ctx, time.perf_counter() - t_start >= ctx.seconds):
            break
    ctx.sync()
    window = time.perf_counter() - t_start
    trace = prof.read() if prof is not None else None
    if trace is not None:
        trace.calls, trace.images = t["trace_calls"], t["trace_calls"] * b
    failed = int(sum(not bool(torch.isfinite(g)) for g in norms))
    capture_s = sum(e.capture_s for e in (step.program.graphs.values() if step.program else ()))
    stats = gather(ctx, (leaf_stats(named), ctx.peak_bytes()))
    out = {"attempted": n_steps, "failed": failed, "peak_bytes": max(p for _, p in stats),
           "trace": trace, "capture_s": capture_s,
           "e2e": {"train_img_per_s": (n_steps - failed) * b * ctx.world / window,
                   "setup_s": ctx.setup_s}}

    del state, step, var, vae, imgs, labels, named, norms
    gc.collect()
    ctx.empty_cache()
    if ctx.rank != 0:
        out["numbers"] = {}
        return out
    out["numbers"] = check.train_numbers(got, reference_steps(ctx))
    if ctx.world > 1:
        out["numbers"]["rank_spread"] = rank_spread([st for st, _ in stats])
    return out


def reference_steps(ctx, prec: M.Prec = M.FP32, keep_rows: int = 0) -> dict:
    """The reference's losses, first gradient and change over the same
    first steps, from the seed alone."""
    t = ctx.traffic
    ref_vae, ref_var = ctx.reference()
    start = {n: p.detach().clone() for n, p in ref_var.named_parameters()}
    trainer = Trainer(ref_vae, ref_var, peak_lr(t), t["twd"], t["tclip"], prec)
    imgs, labels = pool(ctx, t["pool"])  # the program's pool, of which the first batches
    gen = step_generator(ctx)
    out = {"losses": []}
    for i in range(t["check_steps"]):
        r = trainer.step(imgs[i, 0], labels[i, 0], gen, keep_rows)
        out["losses"].append(r["loss"])
        if i == 0:
            out["grad_norms"] = r["grad_norms"]
    out["changes"] = trainer.param_change(start)
    return out
