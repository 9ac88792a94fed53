"""Zero-shot VAR-as-classifier (counterpart of ``var_tpu/apps/classify.py``;
reference ``eval_prob.py``):

    python -m var_tpu_torch.apps.classify --data_path <folder of class subdirs> \\
        --var_ckpt var_d16.pth --mode bayesian --num_classes 10

Classifies an image as the argmax over class conditions of a likelihood
score. Modes (reference ``eval_prob.py:433-584``):

* ``bayesian``: the sum of teacher-forced ground-truth token log-probs;
  ``Clayer`` restricts it to scales >= Clayer;
* ``smooth_bayesian``: the same after rank-group-k smoothing of the token
  distribution (:func:`smooth_log_probs_by_k`, ``eval_prob.py:37-92``);
* ``fast_neighbor_bayesian``: per position, the best log-prob over the
  codebook neighbours of the GT token within an L2 threshold;
* ``neighbor_bayesian``: the log-likelihood of the neighbour-constrained
  ``smooth_sampling`` decode;
* ``gen``: per class, greedy-inpaint the scales >= Clayer and score by the
  negative L1 distance of features to the original's: ``vae_fhat`` or
  ``vae_post``. The ``resnet50``, ``clip`` and ``dinov2`` features need
  pretrained weights that are not in the repository, and raise.

Teacher-forced scoring goes through ``var_forward`` (the training-attention
kernel's forward on the GPU) with TF32 off. The tokenizer, the scores and
the decodes of ``neighbor_bayesian`` and ``gen`` are compiled: on CUDA each
replays a CUDA graph (``engine/compiled.py``). A per-image JSON cache makes
a run resumable (``eval_prob.py:409-416``). ``--device`` defaults to ``cuda``;
``cpu`` runs the plain PyTorch path. Scores run in float32 unless the
caller passes another ``dtype``, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from var_tpu_torch.device import fp32_exact
from var_tpu_torch.engine import sampler as sampler_mod
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod

MODES = ("bayesian", "smooth_bayesian", "fast_neighbor_bayesian", "neighbor_bayesian", "gen")
FEATURES = ("vae_fhat", "vae_post", "resnet50", "clip", "dinov2")


def smooth_log_probs_by_k(log_probs: torch.Tensor, k: int) -> torch.Tensor:
    """Rank-group smoothing: average the probabilities within groups of k
    ranks (descending; the last group may be short), scatter back, re-log
    (``eval_prob.py:37-92``). Equal probabilities keep their index order, as
    the JAX package's stable ``argsort`` does."""
    b, l, v = log_probs.shape
    probs = log_probs.exp()
    order = torch.argsort(-probs, dim=-1, stable=True)
    pad = (-v) % k
    sp = F.pad(torch.gather(probs, -1, order), (0, pad))
    valid = F.pad(torch.ones_like(probs), (0, pad))
    counts = valid.reshape(b, l, -1, k).sum(-1)
    mean = sp.reshape(b, l, -1, k).sum(-1) / counts.clamp(min=1.0)
    smoothed = mean.repeat_interleave(k, dim=-1)[:, :, :v]
    ranks = torch.argsort(order, dim=-1)
    return torch.log(torch.gather(smoothed, -1, ranks) + 1e-10)


def cumsum_tokens(patch_nums: Sequence[int]) -> List[int]:
    out, c = [0], 0
    for pn in patch_nums:
        c += pn * pn
        out.append(c)
    return out


class VARClassifier:
    """Likelihood-based zero-shot classifier over class conditions, on the
    device the modules are on.

    Its programs are compiled (``engine/compiled.py``), as the JAX
    classifier jits ``_tokenize`` and ``_score`` (``classify.py:89-90``):
    on CUDA each replays one CUDA graph an input shape (a ragged last score
    batch is a second entry). ``neighbor_bayesian`` calls the compiled
    smooth sampler and ``gen`` the compiled inpainting decode, once a class
    at batch 1 (JAX runs those two loops unjitted: a replay gives what the
    eager call gives)."""

    def __init__(self, var: var_mod.VAR, vae: vae_mod.VQVAE, mode: str = "bayesian",
                 Clayer: int = 0, threshold: float = 2.0, smooth_k: int = 50,
                 cfg_scale: float = 1.5, feat: str = "vae_fhat",
                 dtype: torch.dtype = torch.float32):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
        self.var, self.vae = var, vae
        self.var_cfg = var.cfg
        self.mode, self.Clayer, self.threshold = mode, Clayer, threshold
        self.smooth_k, self.cfg_scale, self.feat, self.dtype = smooth_k, cfg_scale, feat, dtype
        self.device = var.pos_1LC.device
        self.cums = cumsum_tokens(self.var_cfg.patch_nums)
        self._tokenize = vae_mod.make_tokenizer(self.device)
        self._score = Compiled(self._score_fn, 1, self.device)
        if mode == "fast_neighbor_bayesian":
            n = min(64, self.var_cfg.vocab_size)  # neighbour table width
            with torch.inference_mode():
                _, self.top_n, self.top_n_dists = sampler_mod.codebook_neighbor_tables(
                    vae.quantize.embedding.weight, n)
        if mode == "neighbor_bayesian":
            self._smooth = sampler_mod.make_smooth_sampler(
                self.var_cfg.vocab_size, cfg_scale, threshold, dtype, self.device)
        if mode == "gen":
            self._decode = sampler_mod.make_sampler(
                var.cfg, vae.cfg, cfg_scale=cfg_scale, top_k=1, dtype=dtype, device=self.device,
                inpainting=True)

    def _score_fn(self, var: var_mod.VAR, labels: torch.Tensor, x_in: torch.Tensor,
                  gt_bl: torch.Tensor):
        """Teacher-forced (per-image sum, per-token) log-likelihoods."""
        with fp32_exact():
            logits = var_mod.var_forward(var, labels, x_in, train=False, dtype=self.dtype)
            log_probs = torch.log_softmax(logits, dim=-1)
            if self.mode == "smooth_bayesian":
                log_probs = smooth_log_probs_by_k(log_probs, self.smooth_k)
        if self.mode == "fast_neighbor_bayesian":
            cand = self.top_n[gt_bl]  # (B, L, n)
            clp = torch.gather(log_probs, -1, cand)
            clp = clp.masked_fill(self.top_n_dists[gt_bl] > self.threshold, float("-inf"))
            token_ll = clp.max(dim=-1).values
        else:
            token_ll = torch.gather(log_probs, -1, gt_bl[..., None])[..., 0]
        if self.Clayer:
            token_ll = token_ll[:, self.cums[self.Clayer]:]
        return token_ll.sum(dim=1), token_ll

    def class_likelihoods(self, img, class_ids: Sequence[int], batch_size: int = 10,
                          generator: Optional[torch.Generator] = None) -> np.ndarray:
        """img: (1, H, W, 3) in [-1, 1] (tensor or numpy). Returns the
        (len(class_ids),) scores. ``generator`` (``gen`` mode): its initial
        seed seeds every class's decode alike (default 0)."""
        img = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            idx_bl = self._tokenize.static(self.vae, img)
            gt = torch.cat(idx_bl, dim=1)
            if self.mode == "gen":
                return self._gen_scores(img, gt, class_ids, generator)
            if self.mode == "neighbor_bayesian":
                return np.asarray([float(self._smooth.static(self.var, self.vae, gt, [c])
                                         .log_likelihood) for c in class_ids])
            x_in = q.idxBl_to_var_input(self.vae.quantize, self.vae.cfg, idx_bl)
            out = []
            for i in range(0, len(class_ids), batch_size):
                cls = torch.tensor(list(class_ids[i:i + batch_size]), device=self.device)
                b = cls.shape[0]
                ll, _ = self._score(self.var, cls, x_in.expand(b, -1, -1), gt.expand(b, -1))
                out.append(ll.float().cpu().numpy())
            return np.concatenate(out)

    def _gen_scores(self, img, gt, class_ids, generator) -> np.ndarray:
        keep = torch.ones(1, self.var_cfg.seq_len, dtype=torch.bool, device=self.device)
        if self.Clayer:
            keep[:, self.cums[self.Clayer]:] = False
        seed = 0 if generator is None else generator.initial_seed()
        feat_in = self._features(img)
        scores = []
        for c in class_ids:
            res = self._decode.static_decode(
                self.var, self.vae, torch.Generator(device=self.device).manual_seed(seed), [c],
                gt, keep)
            feat_gen = self._features(res.image * 2.0 - 1.0)
            scores.append(-float((feat_in - feat_gen).abs().mean()))
        return np.asarray(scores)

    def _features(self, img_pm1: torch.Tensor) -> torch.Tensor:
        if self.feat == "vae_fhat":
            return vae_mod.img_to_fhat(self.vae, img_pm1)[-1].reshape(-1)
        if self.feat == "vae_post":
            with fp32_exact():
                return vae_mod.img_to_f(self.vae, img_pm1).reshape(-1)
        if self.feat in FEATURES:
            raise ValueError(f"feature {self.feat!r} needs pretrained {self.feat} weights, "
                             "which are not in the repository; use vae_fhat or vae_post")
        raise ValueError(f"unknown feat {self.feat!r}")

    def classify(self, img, num_classes: Optional[int] = None, batch_size: int = 10) -> int:
        ids = list(range(num_classes or self.var_cfg.num_classes))
        return int(np.argmax(self.class_likelihoods(img, ids, batch_size)))


def run_eval(classifier: VARClassifier, dataset, out_dir: str, num_classes: int = 10,
             limit: Optional[int] = None, batch_size: int = 10) -> float:
    """Folder evaluation with a per-image JSON cache (``eval_prob.py:400-612``):
    ``dataset`` yields (image (H, W, 3) in [-1, 1], label). Returns the
    accuracy in percent."""
    os.makedirs(out_dir, exist_ok=True)
    correct = total = 0
    for idx, (img, label) in enumerate(dataset):
        if limit is not None and idx >= limit:
            break
        cache = os.path.join(out_dir, f"{idx}.json")
        if os.path.exists(cache):
            with open(cache) as f:
                d = json.load(f)
        else:
            pred = classifier.classify(np.asarray(img)[None], num_classes, batch_size)
            d = {"pred": pred, "label": int(label)}
            with open(cache, "w") as f:
                json.dump(d, f)
        correct += int(d["pred"] == d["label"])
        total += 1
    acc = 100.0 * correct / max(total, 1)
    print(f"Final accuracy: {acc:.2f}% ({correct}/{total})")
    return acc


def main(argv=None):
    """The command line (reference ``eval_prob.py`` main, :235-609)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--vae_ckpt", default="vae_ch160v4096z32.pth")
    p.add_argument("--var_ckpt", default="")
    p.add_argument("--pn", default="1_2_3_4_5_6_8_10_13_16")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_dir", default="clf_out")
    p.add_argument("--mode", default="bayesian", choices=MODES)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--Clayer", type=int, default=0)
    p.add_argument("--threshold", type=float, default=2.0)
    p.add_argument("--smooth_k", type=int, default=50)
    p.add_argument("--cfg", type=float, default=1.5)
    p.add_argument("--feat", default="vae_fhat", choices=FEATURES)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--limit", type=int, default=0)
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
    vae_cfg, var_cfg, vae, var = build_vae_var(
        device=dev, patch_nums=pns, depth=args.depth,
        num_classes=max(args.num_classes, 1000) if args.var_ckpt else args.num_classes,
        vae_ckpt=args.vae_ckpt if os.path.exists(args.vae_ckpt) else None,
        var_ckpt=args.var_ckpt if os.path.exists(args.var_ckpt) else None,
        dtype=torch.float32)
    cls_map = None
    if args.imagenet_a_json:
        cls_map = build_imagenet_a_class_map(args.imagenet_a_json, args.data_path)
    ds = FolderDataset(args.data_path, class_to_idx=cls_map)
    tf = make_transform(pns[-1] * vae_cfg.downsample, train=False)
    rng = np.random.default_rng(0)
    clf = VARClassifier(var, vae, mode=args.mode, Clayer=args.Clayer, threshold=args.threshold,
                        smooth_k=args.smooth_k, cfg_scale=args.cfg, feat=args.feat)
    images = ((tf(path, rng), label) for path, label in ds.samples)
    return run_eval(clf, images, args.out_dir, num_classes=args.num_classes,
                    limit=args.limit or None, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
