"""The sampling generator: a closed loop of one client over the program's
compiled CFG sampler (``var_tpu_torch.engine.sampler.make_sampler``).

A traffic file of kind ``sample`` gives ``batch``, ``labels`` (the class
layout of a request), ``cfg``, ``top_k``, ``top_p``, ``dtype``,
``greedy_every`` (every n-th request decodes greedily, top-k 1, so that
its tokens can be held to the reference's best), ``check`` (how many
greedy and sampled requests the check draws) and ``trace_calls``.

Request k carries the labels of its layout and decodes from a generator
seeded ``seed + k + 1`` (the FID protocol's chunk seeds); a request is timed
from its call until its images are uint8 on the host, the values the FID
protocol writes (``apps/fid_sample.py::decode_chunks``: ``clip(image *
255, 0, 255)`` truncated), converted on the card so that the host's share
of the loop stays small. The generator drives ``make_sampler`` itself, as
``decode_chunks`` does, because the check needs the served tokens, which
``decode_chunks`` drops.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.harness import check, weights
from benchmark.harness.trace import Profiled

LAYOUTS = ("one_class_per_batch", "pairs_of_four")


def labels_of(layout: str, seed: int, k: int, batch: int, num_classes: int) -> np.ndarray:
    """Request k's labels. ``one_class_per_batch``: the FID protocol's
    batches of one class, in class order from a class drawn from the seed;
    ``pairs_of_four``: the demo's grid, 4 classes drawn for the request,
    each twice (``batch`` 8)."""
    if layout == "one_class_per_batch":
        c0 = int(np.random.default_rng([seed, 1]).integers(num_classes))
        return np.full(batch, (c0 + k) % num_classes, dtype=np.int64)
    if layout == "pairs_of_four":
        cls = np.random.default_rng([seed, 2, k]).choice(num_classes, batch // 2, replace=False)
        return np.repeat(cls, 2).astype(np.int64)
    raise ValueError(f"unknown label layout {layout!r}: want one of {LAYOUTS}")


def port_config(cfg: dict) -> dict:
    """The program's hub-style config (``from_pretrained_dict``)."""
    vae = cfg["vae"]
    return {"depth": cfg["depth"], "embed_dim": cfg["embed_dim"], "num_heads": cfg["num_heads"],
            "mlp_ratio": cfg["mlp_ratio"], "norm_eps": cfg["norm_eps"],
            "shared_aln": cfg["shared_aln"], "attn_l2_norm": cfg["attn_l2_norm"],
            "patch_nums": list(cfg["patch_nums"]), "num_classes": cfg["num_classes"],
            "cond_drop_rate": cfg["cond_drop_rate"], "drop_path_rate": cfg["drop_path_rate"],
            "vae_kwargs": {"vocab_size": cfg["vocab_size"], "z_channels": cfg["z_channels"],
                           "ch": vae["ch"], "share_quant_resi": vae["share_quant_resi"],
                           "beta": vae["beta"], "using_znorm": vae["using_znorm"]}}


def p95(latencies, failed: int) -> float:
    """Nearest-rank 95th percentile, a failed request counting as missing
    every limit."""
    lat = sorted(latencies) + [float("inf")] * failed
    return lat[max(0, int(np.ceil(0.95 * len(lat))) - 1)]


def run(ctx) -> dict:
    import torch

    from var_tpu_torch.engine.sampler import make_sampler
    from var_tpu_torch.models import from_pretrained_dict

    t, s, dev, seed = ctx.traffic, ctx.sizes, ctx.device, ctx.seed
    dtype = getattr(torch, t["dtype"])
    b = t["batch"]
    ctx.phase("imports")
    sd = weights.make(s, seed, dev)
    vae_cfg, var_cfg, vae, var = from_pretrained_dict(port_config(ctx.config), sd, device=dev,
                                                      dtype=dtype)
    del sd
    ctx.phase("weights")
    kw = dict(cfg_scale=t["cfg"], top_k=t["top_k"], top_p=t["top_p"], dtype=dtype, device=dev)
    samplers = {False: make_sampler(var_cfg, vae_cfg, **kw),
                True: make_sampler(var_cfg, vae_cfg, **{**kw, "top_k": 1, "top_p": 0.0})}

    def request(k: int):
        greedy = t["greedy_every"] > 0 and k % t["greedy_every"] == t["greedy_every"] - 1
        return labels_of(t["labels"], seed, k, b, s.num_classes), greedy

    def call(k: int):
        labels, greedy = request(k)
        gen = torch.Generator(device=dev).manual_seed(seed + k + 1)
        res = samplers[greedy](var, vae, gen, labels)
        img = res.image.mul(255).clamp_(0, 255).to(torch.uint8).cpu().numpy()
        return res.tokens, img

    for sampler in samplers.values():  # capture, then one replay, on seeds the window never uses
        for k in (1, 2):
            labels = labels_of(t["labels"], seed + k, 0, b, s.num_classes)
            sampler(var, vae, torch.Generator(device=dev).manual_seed(seed + 2 ** 40 + k), labels)
    ctx.sync()
    ctx.phase("capture and warm-up")
    done, lat, failed, k, prof = {}, [], 0, 0, None
    t_start = time.perf_counter()
    ctx.setup_s = t_start - ctx.t0
    while True:
        t0 = time.perf_counter()
        try:
            if ctx.trace and k == 0:
                with Profiled() as prof:
                    for j in range(t["trace_calls"]):
                        done[j] = call(j)
                    ctx.sync()
                k = t["trace_calls"]
            else:
                done[k] = call(k)
                k += 1
            lat.append((time.perf_counter() - t0) * 1e3)
        except RuntimeError as e:  # a failed request is counted, not retried
            ctx.log(f"request {k} failed: {e}")
            failed += 1
            k += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.sync()
    window = time.perf_counter() - t_start
    peak = ctx.peak_bytes()
    trace = prof.read() if prof is not None else None
    if trace is not None:
        trace.calls, trace.images = t["trace_calls"], t["trace_calls"] * b
    capture_s = sum(e.capture_s for sm in samplers.values() for e in sm.graphs.values())
    out = {"attempted": k, "failed": failed, "peak_bytes": peak, "trace": trace,
           "capture_s": capture_s,
           "e2e": {"sample_img_per_s": len(done) * b / window,
                   "sample_p95_ms": p95(lat, failed),
                   "setup_s": ctx.setup_s}}

    # the check: a sample of the finished requests drawn from the seed
    greedy_k = [j for j in sorted(done) if request(j)[1]]
    sampled_k = [j for j in sorted(done) if not request(j)[1]]
    rng = np.random.default_rng([seed, 3])
    pick = [*rng.permutation(greedy_k)[:t["check"]["greedy"]],
            *rng.permutation(sampled_k)[:t["check"]["sampled"]]]
    served = [{"labels": torch.as_tensor(request(j)[0], device=dev), "tokens": done[j][0],
               "images": torch.as_tensor(done[j][1], device=dev), "greedy": request(j)[1]}
              for j in pick]
    del samplers, var, vae, done
    gc.collect()
    ctx.empty_cache()
    ref_vae, ref_var = ctx.reference()
    out["numbers"] = check.sample_numbers(ref_vae, ref_var, t, served)
    out["checked"] = {"greedy": sum(bool(r["greedy"]) for r in served),
                      "sampled": sum(not r["greedy"] for r in served)}
    out["served"] = served
    return out
