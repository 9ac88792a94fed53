"""Per-scale likelihood analysis and model-size comparison (counterpart of
``var_tpu/apps/analysis.py``)::

    python -m var_tpu_torch.apps.analysis --data_path <folder of class subdirs> \\
        --depths 16,30 --var_ckpts var_d16.pth,var_d30.pth [--cfg 1.5] [--l2_dist] [--plot]

Covers the reference analysis tooling:

* ``var_analysis.py``: teacher-forced per-scale / accumulated log-likelihood
  classification accuracies (ref :435-524), manual CFG on logits with the
  per-scale ramp (ref :320-344), ``l2_dist`` probability-weighted
  codebook-distance scoring (ref :468-524), per-image JSON dumps, KDE /
  prob-vs-distance plots with savgol smoothing (ref :655-914);
* ``var_size_analysis.py``: the same analysis for several model sizes
  (e.g. d16 vs d30) in one pass, side by side.

Scoring goes through ``models/var.py::var_forward`` with its default
``paired`` attention (the training-attention kernel's forward, row 6, on
the GPU), in float32 with TF32 off unless the caller passes another
``dtype``. The CLI writes one JSON per image (resume-safe), which
``apps/investigate.py`` consumes. ``--device`` defaults to ``cuda``;
``cpu`` runs the plain PyTorch path. The plots need matplotlib and are
imported only under ``--plot``; reading images needs Pillow.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from var_tpu_torch.config import VARConfig
from var_tpu_torch.device import fp32_exact
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod


def scale_segments(cfg: VARConfig) -> List[slice]:
    return [slice(b, e) for b, e in cfg.begin_ends]


def teacher_forced_log_probs(var: var_mod.VAR, labels: torch.Tensor, x_in: torch.Tensor,
                             gt_bl: torch.Tensor, cfg_scale: float = 0.0,
                             dtype: torch.dtype = torch.float32):
    """((B, L) per-position GT log-probs, (B, L, V) log-probs); with
    ``cfg_scale`` > 0, manual CFG against the null class with the per-scale
    ramp t = cfg * si/(S-1) (reference var_analysis.py:320-344)."""
    cfg = var.cfg
    logits = var_mod.var_forward(var, labels, x_in, train=False, dtype=dtype)
    if cfg_scale > 0:
        null = torch.full_like(labels, cfg.num_classes)
        logits_u = var_mod.var_forward(var, null, x_in, train=False, dtype=dtype)
        ramp = np.zeros(cfg.seq_len, np.float32)
        for si, (b, e) in enumerate(cfg.begin_ends):
            ramp[b:e] = cfg_scale * si / cfg.num_stages_minus_1
        t = torch.from_numpy(ramp).to(logits.device)[None, :, None]
        logits = (1 + t) * logits - t * logits_u
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, gt_bl[..., None])[..., 0], logp


def l2_dist_scores(logp: torch.Tensor, gt_bl: torch.Tensor,
                   embedding: torch.Tensor) -> torch.Tensor:
    """(B, L) probability-weighted codebook distance to the GT token:
    E_{v~p}[ ||e_v - e_gt||_2 ] (reference ``l2_dist`` mode,
    var_analysis.py:468-524). Lower = better."""
    emb = embedding.float()
    sq = (emb * emb).sum(dim=1)
    d = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2 * (emb @ emb.T), min=0.0))
    return (logp.exp() * d[gt_bl]).sum(dim=-1)  # d[gt]: (B, L, V) dist(gt, v)


def per_scale_sums(token_ll: torch.Tensor, cfg: VARConfig) -> torch.Tensor:
    """(B, S) per-scale sums of per-position scores."""
    return torch.stack([token_ll[:, s].sum(dim=1) for s in scale_segments(cfg)], dim=1)


def make_score_fn(var: var_mod.VAR, vae: vae_mod.VQVAE, cfg_scale: float = 0.0,
                  l2_dist: bool = False, dtype: torch.dtype = torch.float32):
    """(labels, x_in, gt) -> (B, S) per-scale scores (higher = better), on
    the modules' device, TF32 off."""

    @torch.inference_mode()
    def fn(labels, x_in, gt_bl):
        with fp32_exact():
            token_ll, logp = teacher_forced_log_probs(var, labels, x_in, gt_bl, cfg_scale, dtype)
            if l2_dist:
                scores = -l2_dist_scores(logp, gt_bl, vae.quantize.embedding.weight)
            else:
                scores = token_ll
            return per_scale_sums(scores, var.cfg)

    return fn


def analyze_image(models: Dict[str, tuple], img: torch.Tensor, label: int,
                  class_ids: Sequence[int], batch_size: int = 10) -> dict:
    """Per-scale likelihood classification of ``img`` (1, H, W, 3) in
    [-1, 1] for every model in ``models`` (name -> (var, vae, score_fn)).

    Returns the per-image record the reference dumps to JSON: per-class
    per-scale scores, per-scale/cumulative predictions, correctness."""
    record: dict = {"label": int(label)}
    for name, (var, vae, score_fn) in models.items():
        dev = var.pos_1LC.device
        with torch.inference_mode():
            idx_bl = vae_mod.img_to_idxBl(vae, torch.as_tensor(img, dtype=torch.float32).to(dev))
            gt = torch.cat(idx_bl, dim=1)
            x_in = q.idxBl_to_var_input(vae.quantize, vae.cfg, idx_bl)
        rows = []
        for i in range(0, len(class_ids), batch_size):
            cls = torch.tensor(list(class_ids[i:i + batch_size]), device=dev)
            b = cls.shape[0]
            rows.append(score_fn(cls, x_in.expand(b, -1, -1), gt.expand(b, -1)).cpu().numpy())
        per_scale = np.concatenate(rows)  # (C, S) log-lik (or -l2dist) sums
        cum = per_scale.cumsum(axis=1)  # scores are "higher is better" already
        record[name] = {
            "per_scale": per_scale.tolist(),
            "pred_per_scale": per_scale.argmax(axis=0).tolist(),
            "pred_cumulative": cum.argmax(axis=0).tolist(),
            "pred": int(cum[:, -1].argmax()),
            "correct_per_scale": (per_scale.argmax(axis=0) == label).tolist(),
            "correct_cumulative": (cum.argmax(axis=0) == label).tolist(),
            "correct": bool(cum[:, -1].argmax() == label),
        }
    return record


# ---------------------------------------------------------------------------
# aggregate metrics + plots (reference var_analysis.py:655-914)


def aggregate(records: List[dict], model_names: Sequence[str]) -> dict:
    out = {}
    for name in model_names:
        recs = [r[name] for r in records]
        cps = np.asarray([r["correct_per_scale"] for r in recs])  # (N, S)
        ccs = np.asarray([r["correct_cumulative"] for r in recs])
        out[name] = {
            "acc_per_scale": (cps.mean(axis=0) * 100).tolist(),
            "acc_cumulative": (ccs.mean(axis=0) * 100).tolist(),
            "acc": float(np.mean([r["correct"] for r in recs]) * 100),
            "n": len(recs),
        }
    return out


def plot_accuracy_curves(agg: dict, patch_nums: Sequence[int], out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = list(range(len(patch_nums)))
    fig, axs = plt.subplots(1, 2, figsize=(11, 4))
    for name, a in agg.items():
        axs[0].plot(xs, a["acc_per_scale"], marker="o", label=name)
        axs[1].plot(xs, a["acc_cumulative"], marker="o", label=name)
    for ax, title in zip(axs, ["per-scale accuracy", "cumulative accuracy"]):
        ax.set_xticks(xs, [f"{p}x{p}" for p in patch_nums])
        ax.set_xlabel("scale")
        ax.set_ylabel("acc (%)")
        ax.set_title(title)
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def create_heatmaps_for_classes(token_scores: np.ndarray, patch_nums: Sequence[int],
                                input_img: np.ndarray, alpha: float = 0.5) -> List[np.ndarray]:
    """Per-class spatial heat maps of per-token scores overlaid on the image
    (reference ``inpainting.py:103-177`` / eval_prob plotting): for each class
    row (C, L), split the flat scores by scale, upsample each (pn, pn) map to
    the image size, average across scales, normalize, and alpha-blend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm

    c, l = token_scores.shape
    h, w = input_img.shape[:2]
    base = (input_img - input_img.min()) / max(np.ptp(input_img), 1e-6)
    overlays = []
    for ci in range(c):
        acc = np.zeros((h, w), np.float64)
        cur = 0
        for pn in patch_nums:
            seg = token_scores[ci, cur:cur + pn * pn].reshape(pn, pn)
            acc += np.kron(seg, np.ones((h // pn + 1, w // pn + 1)))[:h, :w]
            cur += pn * pn
        acc /= len(patch_nums)
        acc = (acc - acc.min()) / max(np.ptp(acc), 1e-6)
        heat = cm.get_cmap("jet")(acc)[..., :3]
        overlays.append((1 - alpha) * base + alpha * heat)
    return overlays


def plot_per_scale_kde(records: List[dict], model_names: Sequence[str],
                       patch_nums: Sequence[int], out_path: str):
    """KDE of per-scale log-likelihoods of the TRUE class, per model
    (reference var_analysis.py:655-760 style distribution plots)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import gaussian_kde

    s = len(patch_nums)
    fig, axs = plt.subplots(1, s, figsize=(3 * s, 3), squeeze=False)
    for name in model_names:
        per = np.asarray([np.asarray(r[name]["per_scale"])[r["label"]] for r in records])
        for si in range(s):
            vals = per[:, si]
            ax = axs[0][si]
            if len(vals) > 2 and np.std(vals) > 1e-9:
                xs = np.linspace(vals.min(), vals.max(), 100)
                ax.plot(xs, gaussian_kde(vals)(xs), label=name)
            ax.set_title(f"{patch_nums[si]}x{patch_nums[si]}")
    axs[0][0].set_ylabel("true-class LL density")
    axs[0][-1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_prob_vs_distance(logp_np: np.ndarray, gt_np: np.ndarray,
                          embedding_np: np.ndarray, out_path: str):
    """Token probability vs codebook distance scatter with savgol smoothing
    + exponential fit (reference var_analysis.py:655-914)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.optimize import curve_fit
    from scipy.signal import savgol_filter

    emb = embedding_np.astype(np.float64)
    sq = (emb ** 2).sum(1)
    dmat = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * emb @ emb.T, 0))
    b, l, v = logp_np.shape
    probs = np.exp(logp_np.reshape(-1, v))
    dists = dmat[gt_np.reshape(-1)]
    order = np.argsort(dists, axis=-1)
    d_sorted = np.take_along_axis(dists, order, -1).mean(0)
    p_sorted = np.take_along_axis(probs, order, -1).mean(0)
    window = max(5, (v // 50) | 1)
    p_smooth = savgol_filter(p_sorted, window_length=window, polyorder=2)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(d_sorted, p_sorted, ".", ms=2, alpha=0.4, label="mean prob")
    ax.plot(d_sorted, p_smooth, "-", lw=2, label=f"savgol (w={window})")
    try:
        popt, _ = curve_fit(lambda x, a, c: a * np.exp(-c * x), d_sorted,
                            np.maximum(p_smooth, 0), p0=(p_sorted.max(), 1.0),
                            maxfev=5000)
        ax.plot(d_sorted, popt[0] * np.exp(-popt[1] * d_sorted), "--",
                label=f"exp fit a={popt[0]:.3g} c={popt[1]:.3g}")
    except (RuntimeError, ValueError):  # no fit: the scatter is still drawn
        pass
    ax.set_xlabel("codebook L2 distance to GT token")
    ax.set_ylabel("mean predicted probability")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--depths", default="16", help="comma list, e.g. 16,30 for size comparison")
    p.add_argument("--vae_ckpt", default="vae_ch160v4096z32.pth")
    p.add_argument("--var_ckpts", default="", help="comma list matching --depths")
    p.add_argument("--pn", default="1_2_3_4_5_6_8_10_13_16")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_dir", default="analysis_out")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--cfg", type=float, default=0.0)
    p.add_argument("--l2_dist", action="store_true")
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--imagenet_a_json", default="",
                   help="imagenet_class_index.json for ImageNet-A folders")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.data.imagenet import (FolderDataset, build_imagenet_a_class_map,
                                             make_transform)
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.models import build_vae_var

    dev = resolve_device(args.device)
    pns = parse_patch_nums(args.pn)
    depths = [int(d) for d in args.depths.split(",")]
    ckpts = args.var_ckpts.split(",") if args.var_ckpts else [""] * len(depths)
    models = {}
    for d, ck in zip(depths, ckpts):
        vae_cfg, _, vae, var = build_vae_var(
            device=dev, patch_nums=pns, depth=d,
            vae_ckpt=args.vae_ckpt if os.path.exists(args.vae_ckpt) else None,
            var_ckpt=ck if ck and os.path.exists(ck) else None, dtype=torch.float32)
        models[f"d{d}"] = (var, vae, make_score_fn(var, vae, cfg_scale=args.cfg,
                                                   l2_dist=args.l2_dist))

    tf = make_transform(pns[-1] * vae_cfg.downsample, train=False)
    cls_map = None
    if args.imagenet_a_json:
        cls_map = build_imagenet_a_class_map(args.imagenet_a_json, args.data_path)
    ds = FolderDataset(args.data_path, class_to_idx=cls_map)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for idx in range(min(args.limit, len(ds))):
        cache = os.path.join(args.out_dir, f"{idx}.json")
        if os.path.exists(cache):
            with open(cache) as f:
                records.append(json.load(f))
            continue
        path, label = ds.samples[idx]
        rec = analyze_image(models, torch.from_numpy(tf(path, rng))[None], label,
                            list(range(args.num_classes)), batch_size=args.batch_size)
        with open(cache, "w") as f:
            json.dump(rec, f)
        records.append(rec)
    agg = aggregate(records, list(models.keys()))
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(agg, f, indent=2)
    print(json.dumps(agg, indent=2))
    if args.plot:
        plot_accuracy_curves(agg, pns, os.path.join(args.out_dir, "accuracy.png"))
        plot_per_scale_kde(records, list(models.keys()), pns,
                           os.path.join(args.out_dir, "kde.png"))
    return agg


if __name__ == "__main__":
    main()
